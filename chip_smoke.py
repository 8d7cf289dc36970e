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
   the ``mma`` route only. Then the reference launcher's default
   invocation, ``--serve-trace --kv-layout legacy``, of the same requests
   on the same model (split K/V pages, each decode step a gather, the
   legacy decode and a scatter): ``mxfp4_matmul`` only, exactly 6L + 1
   launches a step, every token in the vocabulary, and one decode window
   eager and captured on a legacy pool (tokens bitwise, launches equal);
   a ``serve legacy`` line (tok/s, the decode step's device ms).
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
   and then on, on a fused pool and then on a legacy one (the reference's
   default layout; there also on again with ``cuda_graphs=False``): per
   layout bitwise equal tokens, hits and no verify failure, fewer
   prefill-chunk steps, the eager legacy run's tokens the captured ones,
   and only ``cim_linear`` and ``paged_decode_mx`` launched (fused) or
   only ``cim_linear`` (legacy); a ``serve chunked`` line a run. One
   legacy decode step's logits on four of the last run's pages against
   ``impl="ref"`` (SQNR >= 30 dB; a ``legacy decode vs impl=ref`` line),
   and a ``layout steps`` line: the decode step (4 lanes at 545..1000
   slots) and the chunk step of both layouts at the 1088-slot page,
   device and wall ms, profiled in this call, with the bytes the legacy
   step's gather and scatter move. Then one load replay of the
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
   busy share), eager and captured: ``WINDOW_FRAMES`` frames each way
   (ViT-L/32: 4, calibrated on one batch: ``VISION_WINDOW_FRAMES``,
   ``VISION_CALIB_BATCHES``, the script's time limit),
   logits bitwise between the two (each chip's step one graph; the
   chain's hidden state is the static buffer between them). A ``serve
   vision`` line a run gives the card's own
   ``fps_host`` and frame times beside, apart and labelled as the
   analytical model's, the FWS pipeline's ``fws_model_fps``, the paper's
   Table 7 ``paper_fps`` and ``err_pct`` (which must stay under 5%).
   ``tiny_vit`` gives the same logits on the card as on the CPU (SQNR >=
   30 dB), and phase 3 also holds both matmul kernels at ViT-B/16's
   shapes (``VIT_CIM_SHAPES``, ``VIT_MM_SHAPES``).
9. Serve the other dense families at full width with the depth cut
   (``DENSE_LAYERS``, the script's time limit): gemma3-1b (12 of 26
   layers: two 5:1 local:global groups, head_dim 256, one KV head, tied
   head; 6 under ``cim``, one group), h2o-danube-1.8b (8 of 24 layers, 4
   under ``cim``; 4096-slot window, head_dim 80) and nemotron-4-15b
   (squared ReLU, LayerNorm, head_dim 128, untied
   256000-row head; 8 of 32 layers, 2 under ``cim``), through the
   launcher's ``build_model``
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
10. Fidelity: the launcher's ``--fidelity`` pass at full width
    (``FID_RUNS``). First the kernel level (``FID_LINEARS``: starcoder2-7b's
    w1 at M=4 on ``splitk`` and M=192 on ``wgmma``, ViT-B/16's w1 at M=197),
    each with a Row-Hist calibration taken on the card and at a quarter of
    its full scale: ``cim_linear_fidelity``'s ``y`` ``torch.equal`` the
    ``cim_linear`` kernel's, its counts (alignment, saturation, code
    occupancy, ``live_e_max``) equal a CPU run on the same tensors, and
    ``quant_health`` on the card equals its CPU run. Then ViT-B/16 (12
    layers) and starcoder2-7b (8 of 32 layers) under ``cim``,
    calibrated on two batches and probed on the first, against the digital
    MXFP4 reference: every calibrated path covered, ``cim_linear``
    launched once an analog linear, no drift; the same with ``adc_fs / 4``
    (drift tripped, output SQNR 3 dB lower or more); a lossless CIM (no
    ADC, CM 64, one pass; starcoder2-7b's first 2 layers,
    ``FID_LOSSLESS_LAYERS``) with ``impl="ref"`` (output SQNR >= 60 dB: the
    reference CI gate's three conditions); and ViT-B/16 ``mxfp4`` against
    float through ``mxfp4_matmul``. A ``fidelity`` line a run: output and
    smallest per-layer SQNR, drift, clip and saturation ratios, the pass's
    wall against one plain eager forward.
11. The MoE family and M-RoPE: mixtral-8x22b (8 experts, top-2, 4096
    window) at 4 layers, qwen3-moe-235b-a22b (128 experts, top-8, G 16)
    at 2 and qwen2-vl-7b (M-RoPE, G 7) at 4 of 28, all at full width
    (``MOE_LAYERS``: a full-width MoE layer is ~10 GB of f32 weights,
    1.3 GB packed; under ``cim`` mixtral and qwen2-vl at 2, qwen3 at 1),
    each under ``mxfp4`` and ``cim`` through phase 9's
    serve (``MOE_RUNS``). The launches by kernel and route are exactly
    ``_dense_launches``'s, which counts kernel C once an expert a bank an
    MoE layer a step under both backends (3E: 24 for mixtral, 384 for
    qwen3) at the step's capacity. Logits of a 384-token prefill and 2
    decode steps against ``impl="ref"`` at SQNR >= 30 dB: for an MoE
    model the ref run takes the kernel run's routing and the decisions
    its own router makes otherwise are counted (``routing_flips``), its
    prefill on its own routing is printed, and under ``cim`` its expert
    products run on C as well (``_moe_hooks``; the hooks' calls and the
    ref run's C launches must be exactly counted). A ``moe layer`` line
    each MoE run: the first layer's MoE at a decode step through C (3E
    launches exactly) against the reference's composition
    (``impl="ref"``: the banks dequantized, one einsum) at SQNR >= 30
    dB, both timed, with the composition's expert products alone, the
    host wall of one eager call and the bound; a ``vision prefill`` line
    for qwen2-vl-7b (``vis_emb`` [1, 64, 1176] through ``front_proj``
    and ``lm.forward``, SQNR >= 30 dB against ``impl="ref"``); captured
    prefill and decode logits bitwise the eager ones; peak memory of the
    build and the serve. First, the kernel rows: C on one expert's slice
    of a packed bank at the expert shapes (cap 2 / 120 for mixtral, 1 /
    30 for qwen3), A at both MoE archs' analog linears, B and D at G 16
    and G 7.
12. The recurrent families and the legacy cache: zamba2-1.2b (38
    Mamba2 layers and six visits of the shared attention block) and
    xlstm-125m (mLSTM and sLSTM, tied head) at full width and depth
    (``REC_LAYERS`` cuts the depth of zamba under ``cim`` to 12 layers and
    two visits, and of xlstm to 6 layers, one sLSTM: the script's time
    limit) through the launcher's ``build_model`` and greedy decode
    (``serve_greedy``: a prefill into the legacy K/V cache and the
    recurrent states, then each decode step two captured graphs) under
    ``mxfp4`` and ``cim`` (``REC_RUNS``): 4 lanes, 512-token prompts, 64
    new tokens; then zamba under ``mxfp4`` on one 2560-token prompt (16
    new tokens); then hubert-xlarge's encoder (48 layers; 12 under
    ``cim``, ``REC_LAYERS``) on one emb batch [1, 1500, 512] under both
    backends. The launches by kernel and route
    are exactly ``_recurrent_launches``'s (A on the calibrated linears
    only: the shared block, the heads and hubert's; C on every packed
    one; E once a shared-block visit a prefill past 256 tokens under
    ``mxfp4``; no paged decode; no kernel at all for xlstm under
    ``cim``). The prefill's last-position logits and 4 decode steps
    against ``impl="ref"`` at SQNR >= 30 dB: under ``mxfp4`` the ref run
    keeps the packed linears on C (the model turns one bf16 ulp of a
    linear's output into ~27 dB at the logits; the all-plain figure and
    the reference's own spread, its composition with f32 sums, are
    printed beside it, and the ref run's C launches counted), and each
    segment kind's first layer alone holds kernels against the plain
    ``impl="ref"`` at 30 dB (``recurrent block``); captured decode ids
    bitwise the eager ones; the tiny model's logits on the card equal
    the CPU's; one prefill and 8 decode steps profiled, eager and
    captured. A ``serve recurrent`` line a run (tok/s, state bytes a
    lane, peak memory) and an ``encode audio`` line a hubert run (launches,
    logits against ``impl="ref"``, device ms and wall). First the kernel
    rows (``REC_SHAPES``): C at every packed linear at M = 4 and the
    prefill's rows, A at the calibrated ones, E at zamba's shared
    attention over [4, 512] and [1, 2560].
13. The stage-parallel FWS pipeline (``distributed/pipeline_exec.py``)
    through the launcher's ``serve_vision`` / ``serve_pipelined_lm`` with
    ``mesh=`` a grid whose places all sit on this card
    (``make_pipeline_mesh(devices=[cuda] * n)``, each place its own stream
    and kernel scratch; the whole step one captured CUDA graph):
    ViT-L/32 ``cim`` at full width and depth over 2 stages (12 + 12), 4
    microbatches of one frame (``PIPE_VIT_ARGS``): launches exactly by
    route (``cim_linear`` only), 8 frames bitwise the two-chip chain of
    phase 8 (captured, one frame a call), captured == eager, 4 frames
    against ``impl="ref"`` (SQNR >= 30 dB), the transfer guard (trunk
    resident before and after three steps; only the activation hop,
    exactly (S - 1) M R mb 145 1024 2 bytes, under a tenth of the trunk),
    the ``pipeline_measured_*`` gauges, one step profiled captured and
    eager (device ms, busy share, ``overlap_ms``: time in which two
    stages' kernels ran at once) and the chain's ``fps_host`` on the same
    frames; a ``serve pipeline`` line. ViT-B/16 ``mxfp4`` over a 2 x 2
    grid (``PIPE_ROUTER_ARGS``) and a ``ReplicaRouter``: three ragged
    submissions, ``dispatched == [2, 1]``, each ticket bitwise the same
    function on one stream with the same rows a launch and >= 30 dB
    against ``vit.forward`` on its rows (``forward_own_spread_db``: C
    splits K by the rows it is given); a ``serve pipeline router`` line.
    starcoder2-7b ``cim`` (8 of 32 layers) over 4 stages, 2 microbatches
    of 2 prompts of 192 tokens (``PIPE_LM_ARGS``): ``parity`` bitwise or
    >= 60 dB against the one-device forward, again on balanced cuts
    from ``serve_layer_costs``, ``cim_linear`` the only kernel; a ``serve
    pipeline lm`` line.
14. Training (no kernel on its path, as in the reference, whose training
    runs no Pallas kernel): h2o-danube-1.8b at full width, 12 of 24
    layers, through ``launch.steps.make_train_step`` under ``mxfp4_ste``
    (prequant) in a loop over ``data.pipeline.Pipeline``, batch [2,
    1024] with ``dense_attn_max`` 512 (the torch-op ``_flash_attn``: the
    flash kernel declines under autograd): 6 steps, each profiled (``train
    step`` lines: loss, grad norm, wall and device ms, busy share,
    tokens/s, peak GiB); step 1's loss within 10% of ln(32000) and
    bitwise the per-call ``mxfp4_ste`` loss; one step with k=1 and one
    with k=2 from the same params (``train k2``: first moments >= 30 dB,
    every attention and FFN weight with a nonzero gradient, all five
    launch counters 0); the step's split (``train full width``: the
    weights' fake-quant, forward + backward with and without the
    activations' fake-quant, AdamW). Then the launcher's ``--mesh none``
    path (``launch.train.main``, tiny danube, 20 steps of [4, 64]): the
    loss falls, a checkpoint from the card restores on the CPU bitwise,
    and kill-restart (6 steps against 3 + a resume to 6) is bitwise under
    ``torch.use_deterministic_algorithms(True)`` (``train launcher``).
    Then tiny danube at ``dense_attn_max`` 16 trains 3 steps on the CPU,
    and the card takes each step from the CPU's state before it (AdamW at
    lr 1, eps 1, no warmup: the params move by ~lr times the gradient):
    per step, losses within 1e-3, each leaf's move and both moments >= 30
    dB, no launch, and kernel E's wrapper raises on CUDA inputs that
    require grad (``train tiny card vs cpu``).
15. The dry run (``launch.dryrun``, ``launch.steps``, ``obs.cost``):
    ``run_cell`` predicts three steps on the one-card mesh
    (``make_local_mesh(1, 1)``), counted on ``meta``: h2o-danube-1.8b 12
    of 24 layers, [2, 1024], ``mxfp4_ste`` (prequant) through
    ``make_train_step``; starcoder2-7b ``mxfp4_wonly`` 16 layers, prefill
    [1, 2048] through ``make_prefill_step`` and decode [4, 1] over a
    2048-token cache through ``make_decode_step``. Each step is then
    built on the card by the same builder from a clean memory state and
    run: ``argument_bytes`` must equal the allocated arguments' bytes, the
    predicted peak (arguments + the counter's temporaries) must be within
    10% of ``max_memory_allocated`` (over the memory in use before the
    arguments), the counter's kernel calls by route must equal the
    wrappers' launches by route, and the measured device ms must be at or
    above the predicted roofline time (``dry run`` lines, with the card's
    name and power limit). Then ``run_cell`` on this host for one cell of
    each family but audio on the single pod (hubert-xlarge's cells take
    minutes there), with its seconds (``dry run sweep``).
16. The sharded steps (``launch.steps``). 16a: an NCCL process group of
    one rank on the card (a ``HashStore``; NCCL takes one rank a GPU) and
    ``make_train_step`` on ``make_local_mesh(1, 1)`` over it, the
    model-aware body at (data, model) = (1, 1) (FSDP parameters, ZeRO-1
    moments, the batch over the data axis, a model axis of 1: no
    tensor-parallel layers; every collective a copy at world 1; the
    model axis on four cards is ``scripts/torch_fsdp_multicard.py``'s):
    phase 14's h2o-danube-1.8b, 12 of 24
    layers, [2, 1024], three steps against phase 14's one-device step
    from the same init, both under deterministic algorithms: parameters,
    moments and losses ``torch.equal``; the allocated argument bytes equal
    ``steps.args_bytes``; the collectives by kind, step and device ms and
    peak GiB (``train sharded``); the group destroyed. 16b:
    ``make_paged_decode_step`` on full-width starcoder2-7b (16 of 32
    layers, built by the launcher's ``build_model``) under
    ``mxfp4_wonly`` on both layouts and under ``cim`` on ``fused``, on a
    random pool: next ids and pool bitwise the engine's own step on a
    copy of the pool, and the launches by route the formula's (``paged
    step`` lines).
17. The sharded serving steps' kernel modes and builders. 17a: kernel C
    with ``out_dtype=float32`` (a row-parallel linear's partial) at
    starcoder2-7b's ``wo`` and ``w2`` at a quarter of their K (1152 x
    4608, 4608 x 4608), M 4 and 2048: on every route that takes the
    rows the f32 output within 1e-5 x max |plain| of the plain version,
    at least half of it off the bf16 grid, and the bf16 output
    ``torch.equal`` to the f32 one cast (``mxfp4_matmul f32 out``
    lines). 17b: kernel A's pass sums at the same slices, both routes:
    each slice's int32 sums ``torch.equal`` to the plain version's,
    four slices' sums read out ``torch.equal`` to A's whole output on
    the same route, and the constructed rounding input's one guarded row
    the only one that differs (``cim_linear pass sums`` lines). 17d:
    kernels B and D in their partial (o, lse) mode (``PARTIAL_CASES``:
    starcoder2-7b's decode shape, W 2048 in 4 blocks; gemma3-1b's, W 448
    in 2), each block's (o, lse) against the plain version's, the whole
    page's o cast ``torch.equal`` to the bf16 mode, the blocks combined
    against the dense decode within 1 dB of the whole page
    (``paged_decode partial`` / ``paged_decode_mx partial`` lines). 17c: an
    NCCL group of one rank and ``make_prefill_step``,
    ``make_decode_step`` and ``make_paged_decode_step`` (legacy and
    fused) on ``make_local_mesh(1, 1)`` over it, starcoder2-7b 16 of 32
    layers under ``mxfp4`` and 8 under ``cim`` (the launcher's
    ``build_model``), [4, 256]: ids and caches ``torch.equal`` to the
    one-device bundles, the sharded steps' launches (C or A, and D or B),
    device ms a step; then prefill, decode and both paged steps with
    ``model_forms`` (the row-parallel linears' modes and the fused
    decode's partial mode at one block, at model 1), ``torch.equal`` to
    the one-device bundles, C's f32 or A's sums mode counted launching
    and D's or B's partial mode once a layer (``sharded serve`` lines;
    the kernels line's phase-17 rows take those counts).
18. Prints the kernels line (phase 9 adds B, D and E at head widths
    256, 80 and 128; phase 11 C at the expert shapes, A at the MoE
    linears and B and D at G 16 and 7; phase 12 A, C and E at the
    recurrent and audio archs' shapes; phase 17 C's f32 output, A's
    pass sums and B's and D's partial mode), then the card's name and
    power limit, then the device
    line, as the last line.

Every measured shape is printed on a line of its own (``cim_linear {...}``,
``paged_decode_mx {...}``, ``mxfp4_matmul {...}``, ``paged_decode {...}``,
``flash_attention {...}``, ``serve {...}``, ``prefill profile {...}``,
``decode profile {...}``, ``serve legacy {...}``, ``serve long {...}``,
``serve chunked {...}``, ``legacy decode vs impl=ref {...}``, ``layout
steps {...}``, ``serve load {...}``, ``prefill eager vs captured
{...}``, ``decode eager vs captured {...}``, ``frame profile <arch>
<mode> {...}``, ``frame eager vs captured {...}``, ``serve vision {...}``,
``serve dense {...}``, ``fidelity linear {...}``, ``fidelity quant_health
{...}``, ``fidelity {...}``, ``moe layer {...}``, ``vision prefill
{...}``, ``recurrent prefill profile {...}``, ``recurrent decode profile
<mode> {...}``, ``serve recurrent {...}``, ``encode audio {...}``,
``serve pipeline {...}``, ``serve pipeline router {...}``, ``serve
pipeline lm {...}``, ``train step {...}``, ``train k2 {...}``, ``train
full width {...}``, ``train launcher {...}``, ``train tiny card vs cpu
{...}``, ``dry run {...}``, ``dry run sweep {...}``, ``train sharded
{...}``, ``paged step {...}``, ``mxfp4_matmul f32 out {...}``,
``cim_linear pass sums {...}``, ``paged_decode partial {...}``,
``paged_decode_mx partial {...}``, ``sharded serve {...}``).
The decode kernels are also checked at the page widths of phases 6 and 7
(``FLOAT_PAGES``, ``MX_PAGES``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
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
                  chunk_len=256, policy="chunked", kv_layout="fused")
SYS_PROMPT, CHUNK_TOKENS = 512, 32  # the shared prefix, new tokens a request
# phase 7's step timing on both pool layouts at CHUNK_ECFG's page: the
# decode lanes' prompt lengths, and the offset of the timed chunk
LAYOUT_LENGTHS, LAYOUT_CHUNK_AT = (545, 1000, 1000, 800), 768
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
# repeat cuts of phase 8 (the frames, widths and depth kept), the script's
# time limit: ViT-L/32 cim (61.3 s on a slow host, its 64 frames 2.2 s of
# it) calibrates on one batch of 2 and profiles windows of 4 frames
VISION_CALIB_BATCHES = {"vit-l32": 1}
VISION_WINDOW_FRAMES = {"vit-l32": 4}
# ViT-B/16's linears at the shapes a frame gives them (PERF.md §6):
# cim_linear (M, K, N) and mxfp4_matmul (M, K, N, x dtype)
VIT_CIM_SHAPES = ((197, 768, 768), (197, 768, 3072))
VIT_MM_SHAPES = ((197, 768, 3072, torch.bfloat16),
                 (196, 768, 768, torch.float32),
                 (1, 768, 1000, torch.bfloat16))
# the three other dense families (phase 9) at full width through the
# launcher's serve_trace: 8 staggered requests of up to 384-token
# prompts ([1, 384] prefills, past dense_attn_max) and 64 new tokens, page
# 448 (inside gemma3-1b's 512-slot local window)
DENSE_RUNS = (("gemma3-1b", "mxfp4"), ("gemma3-1b", "cim"),
              ("h2o-danube-1.8b", "mxfp4"), ("h2o-danube-1.8b", "cim"),
              ("nemotron-4-15b", "mxfp4"), ("nemotron-4-15b", "cim"))
# depth cuts of phase 9 (width kept): nemotron-4-15b's f32 weights before
# conversion are ~62 GB at 32 layers (390 M parameters a layer, 1.57 G in
# each of the embedding and the untied head), ~25 GB at 8; gemma3-1b (two
# local:global groups) and h2o-danube-1.8b for the script's time limit
# (at full depth their cim runs took 116 s and 125 s of the script's 1064 s
# on one H100), and nemotron-4-15b under cim to 4 layers for phase 13 (74
# s of an 880 s run at 8); gemma3-1b under cim to 6 (one local:global
# group) and h2o-danube-1.8b under cim to 4 for phase 14 (65.1 s and
# 53.6 s of a 1141 s run on a slow host at 12 and 8 layers; 21.2 s and
# 19.2 s at 6 and 4 in a 782.5 s run); nemotron-4-15b under cim to 2
# layers (57.9 s of a 1122.8 s run on a slow host at 4, most of it the f32
# embedding and head), to make room for phase 17's partial-mode checks
# within the time limit, with phase 8's VISION_CALIB_BATCHES /
# VISION_WINDOW_FRAMES, phase 10's FID_ARGS and phase 12's REC_LAYERS
# (hubert-xlarge)
DENSE_LAYERS = {"nemotron-4-15b": 8, "gemma3-1b": 12, "h2o-danube-1.8b": 8,
                ("nemotron-4-15b", "cim"): 2, ("gemma3-1b", "cim"): 6,
                ("h2o-danube-1.8b", "cim"): 4}
DENSE_PROMPT, DENSE_TOKENS, DENSE_PAGE = 384, 64, 448
DENSE_ARGS = ["--no-tiny", "--serve-trace", "--kv-layout", "fused",
              "--requests", "8", "--lanes", "4", "--slots", "6",
              "--prompt-len", str(DENSE_PROMPT), "--tokens",
              str(DENSE_TOKENS), "--calib-batches", "2", "--batch", "2"]
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
# the MoE family and M-RoPE (phase 11): mixtral-8x22b, qwen3-moe-235b-a22b
# and qwen2-vl-7b at full width through phase 9's serve (DENSE_ARGS), the
# depth cut (width kept): a full-width MoE layer is ~2.5 G f32 parameters
# (10 GB) before conversion, 1.3 GB packed; qwen3-moe (1553 launches a
# step at 4 layers, ~30 ms a layer eager) and qwen2-vl at half of that
# for the script's time limit
MOE_RUNS = (("mixtral-8x22b", "mxfp4"), ("mixtral-8x22b", "cim"),
            ("qwen3-moe-235b-a22b", "mxfp4"), ("qwen3-moe-235b-a22b", "cim"),
            ("qwen2-vl-7b", "mxfp4"), ("qwen2-vl-7b", "cim"))
MOE_LAYERS = {"mixtral-8x22b": 4, "qwen3-moe-235b-a22b": 2,
              "qwen2-vl-7b": 4, ("mixtral-8x22b", "cim"): 2,
              ("qwen3-moe-235b-a22b", "cim"): 1,
              ("qwen2-vl-7b", "cim"): 2}
# the cim cuts for phase 14: mixtral, qwen3-moe and qwen2-vl took 27.4 s,
# 35.7 s and 31.4 s of a 1141 s run on a slow host at 4, 2 and 4 layers;
# 12.5 s, 18.7 s and 14.7 s at 2, 1 and 2 in a 782.5 s run
MOE_STEPS = 2  # teacher-forced decode steps held to impl="ref"
# the decode kernels at the new query groups: qwen3-moe's G 16 (the
# kernels' G_MAX) and qwen2-vl's odd G 7 (lanes, Hkv, G, head_dim)
MOE_DECODE_DIMS = {"qwen3-moe-235b-a22b": (4, 4, 16, 128),
                   "qwen2-vl-7b": (4, 4, 7, 128)}
VIS_TOKENS = 64  # qwen2-vl's vision prefill: vis_emb [1, 64, 1176]
# the fidelity phase (phase 10): the launcher's --fidelity pass at full
# width on ViT-B/16 (12 layers, the paper's workload) and starcoder2-7b
# at 8 of 32 layers, both cim, calibrated on their two
# calibration batches and probed on the first; ViT-B/16 mxfp4 against
# float through mxfp4_matmul
FID_COMMON = ["--no-tiny", "--calib-batches", "2", "--batch", "2",
              "--fidelity", "--log-level", "warning"]
FID_RUNS = (("vit-b16", "cim"), ("starcoder2-7b", "cim"),
            ("vit-b16", "mxfp4"))
FID_ARGS = {"vit-b16": [], "starcoder2-7b": ["--layers", "8",
                                             "--prompt-len", "192"]}
# the lossless CIM's check on the first layers of the model only (a depth
# cut, the script's time limit: at 8 layers its calibration and impl="ref"
# pass took ~20 s of starcoder2-7b's 59.4 s on a slow host; it measured
# ~300 dB at 4 layers against its 60 dB bound)
FID_LOSSLESS_LAYERS = {"starcoder2-7b": 2}
FID_MISCAL = 0.25  # adc_fs scale of the mis-calibrated run
FID_MIN_DROP_DB = 3.0  # its output SQNR drop, at least
FID_LOSSLESS_MIN_DB = 60.0  # the reference CI gate's lossless bound
# the kernel-level rows (M, K, N): starcoder2-7b's w1 at decode (splitk)
# and prefill (wgmma), ViT-B/16's w1 at a frame's rows
FID_LINEARS = ((4, 4608, 18432), (192, 4608, 18432), (197, 768, 3072))
# the recurrent families and the audio encoder (phase 12): xlstm-125m and
# zamba2-1.2b at full width and depth through the launcher's greedy
# decode (4 lanes, 512-token prompts, 64 new tokens) under mxfp4 and cim,
# zamba once more under mxfp4 on one 2560-token prompt (16 new tokens),
# and hubert-xlarge's encoder on one emb batch [1, 1500, 512] (30 s of
# audio at 50 frames a second) under both backends
REC_RUNS = (("zamba2-1.2b", "mxfp4"), ("zamba2-1.2b", "cim"),
            ("xlstm-125m", "mxfp4"), ("xlstm-125m", "cim"))
# depth cuts of phase 12 (width kept), the script's time limit: zamba2-1.2b
# cim to 12 of 38 Mamba layers (two shared-block visits), xlstm-125m to 6
# of 12 layers (sLSTM at layer 3), hubert-xlarge's encoder under cim to 12
# of 48 (62.0 s of a 1122.8 s run at 48: its calibration and the plain
# CIM forward at 1500 rows, per layer)
REC_LAYERS = {("zamba2-1.2b", "cim"): 12, ("xlstm-125m", "mxfp4"): 6,
              ("xlstm-125m", "cim"): 6, ("hubert-xlarge", "cim"): 12}
REC_BATCH, REC_PROMPT, REC_TOKENS = 4, 512, 64
REC_LONG_PROMPT, REC_LONG_TOKENS = 2560, 16
REC_STEPS = 4  # decode steps held to impl="ref"
AUDIO_FRAMES = 1500
_BF, _F32 = torch.bfloat16, torch.float32
_DEC_PRE = ((4, _BF), (REC_BATCH * REC_PROMPT, _BF))
# per arch: (linear, K, N, (rows, x dtype) of its calls, calibrated under
# cim); a shape shared by two linears is listed once
REC_SHAPES = {
    "zamba2-1.2b": (("mamba in_proj", 2048, 8384, _DEC_PRE, False),
                    ("shared w_in, mamba out_proj", 4096, 2048, _DEC_PRE,
                     True),
                    ("shared wq/wk/wv/wo, w_out", 2048, 2048, _DEC_PRE, True),
                    ("shared w1", 2048, 8192, _DEC_PRE, True),
                    ("shared w2", 8192, 2048, _DEC_PRE, True),
                    ("head", 2048, 32000, ((4, _BF),), True)),
    "xlstm-125m": (("mLSTM w_up, sLSTM w_in", 768, 3072, _DEC_PRE, False),
                   ("mLSTM wq/wk", 1536, 1536,
                    ((4, _F32), (REC_BATCH * REC_PROMPT, _BF)), False),
                   ("mLSTM w_down", 1536, 768, _DEC_PRE, False),
                   ("sLSTM w_up", 768, 2048, _DEC_PRE, False),
                   ("sLSTM w_down", 1024, 768, _DEC_PRE, False)),
    "hubert-xlarge": (("front_proj", 512, 1280, ((AUDIO_FRAMES, _F32),),
                       True),
                      ("wq/wk/wv/wo", 1280, 1280, ((AUDIO_FRAMES, _BF),),
                       True),
                      ("w1", 1280, 5120, ((AUDIO_FRAMES, _BF),), True),
                      ("w2", 5120, 1280, ((AUDIO_FRAMES, _BF),), True),
                      ("head", 1280, 504, ((AUDIO_FRAMES, _BF),), True)),
}
# the stage-parallel pipeline (phase 13) through the launcher's
# serve_vision / serve_pipelined_lm, every grid place on the one card:
# ViT-L/32 cim over 2 stages, 4 microbatches of one frame (mb_size =
# ceil(frames / (replicas * microbatches))); ViT-B/16 mxfp4 over a 2 x 2
# grid; starcoder2-7b cim (8 of 32 layers, phase 4's model) over 4 stages,
# 2 microbatches of 2 prompts of 192 tokens
PIPE_VIT_ARGS = ["--arch", "vit-l32", "--backend", "cim", "--no-tiny",
                 "--stages", "2", "--microbatches", "4", "--frames", "4",
                 "--calib-batches", "2", "--batch", "2",
                 "--log-level", "warning"]
PIPE_FRAMES = 8  # frames held to the chain: two steps of 4 frames
PIPE_ROUTER_ARGS = ["--arch", "vit-b16", "--backend", "mxfp4", "--no-tiny",
                    "--mesh", "2x2", "--microbatches", "2", "--frames", "4",
                    "--log-level", "warning"]
PIPE_LM_ARGS = ["--no-tiny", "--layers", "8", "--backend", "cim",
                "--stages", "4", "--microbatches", "2", "--batch", "4",
                "--prompt-len", "192", "--calib-batches", "2",
                "--log-level", "warning"]
# the training phase (phase 14): h2o-danube-1.8b (the training launcher's
# default arch) at full width through launch.steps.make_train_step, the
# loop body of the reference launcher's mesh branch; depth cut to 12 of 24
# layers (the script's time limit; ~1.0 B f32 params, with m, v and the
# gradients ~16 GB); batch [2, 1024] with dense_attn_max 512, so the
# prefill past it takes the differentiable torch-op _flash_attn
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_LAYERS = 12
TRAIN_SEQ, TRAIN_BATCH = 1024, 2
TRAIN_DENSE_MAX = 512
TRAIN_STEPS = 6
TRAIN_K2_MIN_SQNR_DB = 30.0  # the k=2 gradient (first moment) vs k=1
TRAIN_LOSS_REL = 0.10  # step 1's loss within 10% of ln(vocab)
# the launcher's --mesh none path as the reference documents it
TRAIN_LAUNCH_ARGS = ["--arch", "h2o-danube-1.8b", "--tiny", "--steps", "20",
                     "--seq", "64", "--batch", "4"]
TRAIN_TINY_MIN_SQNR_DB = 30.0  # card vs CPU, per leaf (moves, moments)
TRAIN_TINY_OPT = dict(lr=1.0, eps=1.0, warmup_steps=0)  # phase 14c's AdamW
# the dry run (phase 15): three steps predicted by launch.dryrun.run_cell on
# the one-card mesh, then run on the card through the same step builders:
# (name, arch, layers, shape as (seq, batch, kind), quant)
DRY_STEPS = (("train", "h2o-danube-1.8b", TRAIN_LAYERS,
              (TRAIN_SEQ, TRAIN_BATCH, "train"), "mxfp4_ste"),
             ("prefill", "starcoder2-7b", 16, (2048, 1, "prefill"),
              "mxfp4_wonly"),
             ("decode", "starcoder2-7b", 16, (2048, 4, "decode"),
              "mxfp4_wonly"))
DRY_PEAK_REL = 0.10  # predicted peak within 10% of max_memory_allocated
DRY_REPS = 3  # timed calls of each step
# the dry-run sweep on the card's host, one cell a family but audio (the
# whole single-pod sweep takes minutes on the CPU, and hubert-xlarge's
# cells 35 s and more each: its long sequences step the torch-op
# _flash_attn's tiles in Python)
DRY_SWEEP = (("h2o-danube-1.8b", "decode_32k"), ("mixtral-8x22b", "decode_32k"),
             ("zamba2-1.2b", "decode_32k"), ("xlstm-125m", "decode_32k"),
             ("qwen2-vl-7b", "prefill_32k"))
# the sharded train step and the paged decode step (phase 16): 16a runs
# launch.steps.make_train_step on make_local_mesh(1, 1) over an NCCL group
# of one rank, phase 14's h2o-danube-1.8b (12 of 24 layers, [2, 1024],
# dense_attn_max 512), SHARD_STEPS steps against the one-device step from
# the same init; 16b runs make_paged_decode_step on starcoder2-7b (16 of
# 32 layers; PAGED_LANES lanes, PAGED_SLOTS slots, pages of PAGED_PAGE)
# under PAGED_RUNS against the engine's own step
SHARD_STEPS = 3
PAGED_LAYERS = 16
PAGED_LANES, PAGED_SLOTS, PAGED_PAGE = 4, 6, 256
PAGED_RUNS = (("mxfp4", "legacy"), ("mxfp4", "fused"), ("cim", "fused"))
PAGED_ARGS = {"mxfp4": ["--no-tiny", "--backend", "mxfp4", "--layers",
                        str(PAGED_LAYERS), "--log-level", "warning"],
              "cim": ["--no-tiny", "--backend", "cim", "--layers",
                      str(PAGED_LAYERS), "--calib-batches", "2", "--batch",
                      "2", "--log-level", "warning"]}
# the sharded serving steps (phase 17): 17a / 17b hold kernel C's f32
# output and kernel A's pass sums (the row-parallel linears' modes) at
# starcoder2-7b's wo and w2 at a quarter of their K (a model rank of 4),
# (K, N), at decode and prefill rows; 17c runs make_prefill_step,
# make_decode_step and make_paged_decode_step on make_local_mesh(1, 1)
# over an NCCL group of one rank against the one-device bundles
ROWPAR_SHAPES = ((1152, 4608), (4608, 4608))
ROWPAR_M = (4, 2048)
ROWPAR_SLICES = 4
# 17a: C's f32 output within this x max |plain| of its plain version (the
# f32 sums' order: 3.8e-6 absolute measured at max |plain| ~5), and at
# least this share of it off the bf16 grid
ROWPAR_F32_TOL = 1e-5
ROWPAR_OFF_BF16 = 0.5
# 17d: kernels B and D in their partial mode (a rank's block of a cache
# sequence cut over ranks) at the decode shapes of starcoder2-7b (W 2048
# in 4 blocks) and gemma3-1b (W 448 in 2): (name, (lanes, Hkv, G, Dh), W,
# blocks, lane lengths); each block's (o, lse) against the plain version's
PARTIAL_CASES = (("starcoder2-7b", (4, 4, 9, 128), 2048, 4,
                  [0, 700, 1500, 2048]),
                 ("gemma3-1b", (4, 1, 4, 256), 448, 2, [0, 1, 300, 448]))
# D's o: its 16-key splits round P to bf16 against the split's own max,
# the plain version against its 128-key chunk's running max, so its f32 o
# differs from the plain one by P's bf16 rounding: held to the bf16
# mode's gates (SQNR and max |err|), its lse to ROWPAR_F32_TOL
PARTIAL_FLOAT_MIN_DB, PARTIAL_FLOAT_ATOL = 40.0, 1e-2
PARTIAL_DROP_DB = 1.0  # the blocks combined vs dense, below the whole page
SERVE_SHARD_LAYERS = {"mxfp4": 16, "cim": 8}
SERVE_SHARD_SEQ, SERVE_SHARD_BATCH = 256, 4
SERVE_SHARD_ARGS = {"mxfp4": ["--no-tiny", "--backend", "mxfp4", "--layers",
                              str(SERVE_SHARD_LAYERS["mxfp4"]),
                              "--log-level", "warning"],
                    "cim": ["--no-tiny", "--backend", "cim", "--layers",
                            str(SERVE_SHARD_LAYERS["cim"]), "--calib-batches",
                            "2", "--batch", "2", "--log-level", "warning"]}
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
    """The least time for ``n_bytes`` at the HBM rate and ``ops`` at the
    peak rate of their type (the kernels' ``cost()`` models give both)."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_bound(b, sq, sk, h, hkv, d, elt: int, pairs: float):
    """``flash_attention``'s bound from its wrapper's cost model
    (``flash_attention/ops.py::cost``: q, k, v read and out written once,
    4 d operations a (query, visible key) pair and head)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return _bound_ms(*fa_ops.cost(b, sq, sk, h, hkv, d, elt, pairs))


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
    bound, by = _bound_ms(*cim_ops.cost(m, k, n, x.element_size()))
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
        bound, by = _bound_ms(*pops.cost_mx(
            lens, hkv, g, dh, quant["kv_codes"].shape[-1],
            quant["k_exps"].shape[-1]))
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
    bound, by = _bound_ms(*mm_ops.cost(m, k, n, x.element_size()))
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
        bound, by = _bound_ms(*pops.cost_float(lens, hkv, g, dh))
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
    run = {"launches": launches, "summary": summary, "profile": prof}
    if backend == "mxfp4":
        run["legacy"] = serve_legacy_trace(cfg, params, ctx)
    return run, (cfg, params, ctx)


def serve_legacy_trace(cfg, params, ctx) -> dict:
    """Phase 5, the reference launcher's default invocation: the same
    ``mxfp4`` model through ``serve_trace`` with ``--kv-layout legacy``
    (split K/V pages; each decode step gathers the lanes' pages, decodes
    and scatters them back). ``mxfp4_matmul`` must be the only kernel, at
    exactly 6L + 1 launches a step (prefill or decode); every token in the
    vocabulary. Then one decode window eager and captured
    (:func:`profile_decode` on a legacy pool): its device ms a step."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(SERVE_ARGS["mxfp4"]
                                           + ["--kv-layout", "legacy"])
    obs = obs_lib.Obs()
    dev = params["embed"]["emb"].device
    _zero_counts()
    summary = serve.serve_trace(args, cfg, params,
                                dataclasses.replace(ctx, obs=obs), obs, dev)
    launches, routes = _read_counts()
    steps = len(obs.steps)
    want = (6 * cfg.n_layers + 1) * steps
    if summary["ecfg"].kv_layout != "legacy" or launches["mxfp4_matmul"] \
            != want or any(v for k, v in launches.items()
                           if k != "mxfp4_matmul"):
        raise AssertionError(f"[mxfp4 legacy] launches {launches}, want "
                             f"mxfp4_matmul only, {want} over {steps} steps")
    for v in summary["out"].values():
        if not v or not all(0 <= t < cfg.vocab_size for t in v):
            raise AssertionError("[mxfp4 legacy] served tokens out of the "
                                 "vocabulary")
    if summary["tokens"] != 8 * args.tokens:
        raise AssertionError(f"[mxfp4 legacy] {summary['tokens']} tokens")
    prof = profile_decode(cfg, params, ctx, kv_layout="legacy")
    print("serve legacy", json.dumps(
        {"backend": "mxfp4", "layers": cfg.n_layers, "kv_layout": "legacy"}
        | {k: v for k, v in summary.items()
           if k not in serve.SUMMARY_DATA + ("prefix",)}
        | {"steps": steps, "launches": launches,
           "launches_a_step": launches["mxfp4_matmul"] / steps,
           "mxfp4_matmul_routes": routes,
           "decode": _step_pair(prof)}), flush=True)
    return {"launches": launches, "summary": summary, "profile": prof}


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


def _chunked_run(cfg, params, ctx, prompts, layout: str, cached: bool,
                 cuda_graphs: bool = True) -> dict:
    """One serve of ``prompts`` through a ``CHUNK_ECFG`` engine on a
    ``layout`` pool: its tokens, its ``serve chunked`` line, and the
    engine (for a look at its pool after the run)."""
    from repro_torch import obs as obs_lib
    from repro_torch.serving import Engine, EngineConfig

    obs = obs_lib.Obs()
    eng = Engine(params, cfg, dataclasses.replace(ctx, obs=obs),
                 EngineConfig(**(CHUNK_ECFG | {"kv_layout": layout}),
                              prefix_cache=cached, cuda_graphs=cuda_graphs),
                 obs=obs)
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
    line = {"backend": "cim", "layers": cfg.n_layers, "kv_layout": layout,
            "cuda_graphs": cuda_graphs, "prefix_cache": cached,
            "requests": len(out), "tokens": n_tok, "wall_s": wall,
            "tok_s": n_tok / wall, "prefill_chunk_steps": len(chunks),
            "chunk_step_ms_p50": float(np.median(chunks)) * 1e3,
            "decode_steps": len(decodes),
            "decode_step_ms_p50": float(np.median(decodes)) * 1e3,
            "ttft_ms_p50": ttft["p50"] * 1e3, "ttft_ms_p99": ttft["p99"] * 1e3,
            "prefix": eng.prefix_stats(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("serve chunked", json.dumps(line), flush=True)
    return {"tokens": [out[r] for r in rids], "line": line, "engine": eng}


def serve_chunked_prefix(cfg, params, ctx) -> dict:
    """Phase 7: the 8-layer ``cim`` model of phase 4 in an engine with
    ``CHUNK_ECFG`` (chunked prefill, 256-token chunks, 1088-slot pages)
    serves :func:`_chunked_prompts` on a fused pool with the prefix cache
    off, then on; then on a legacy pool (the reference's default layout)
    off and on, captured, and on again eagerly (``cuda_graphs=False``).
    On each layout the tokens must be bitwise equal off and on, the cache
    must hit with no verify failure and save prefill-chunk steps; the
    eager legacy run must give the captured tokens. Launches: on the
    fused pool ``cim_linear`` and ``paged_decode_mx`` (and no other
    kernel), on the legacy pool ``cim_linear`` only. Then one legacy
    decode step's logits on the last run's pages against ``impl="ref"``
    (:func:`_legacy_decode_vs_ref`) and the two layouts' decode and chunk
    steps timed in this call (:func:`profile_layout_steps`)."""
    prompts = _chunked_prompts(cfg.vocab_size)
    runs, launches = {}, {}
    for layout, modes in (("fused", ((False, True), (True, True))),
                          ("legacy", ((False, True), (True, True),
                                      (True, False)))):
        _zero_counts()
        for cached, graphs in modes:
            run = _chunked_run(cfg, params, ctx, prompts, layout, cached,
                               graphs)
            if (layout, cached, graphs) != ("legacy", True, False):
                del run["engine"]
            runs[layout, cached, graphs] = run
        launches[layout], _ = _read_counts()
        print("serve chunked launches", json.dumps(
            {"kv_layout": layout, "launches": launches[layout],
             "cim_linear_routes": _cim_routes()}), flush=True)
    own = {"fused": {"cim_linear", "paged_decode_mx"},
           "legacy": {"cim_linear"}}
    for layout in ("fused", "legacy"):
        off, on = runs[layout, False, True], runs[layout, True, True]
        stats = on["line"]["prefix"]
        if on["tokens"] != off["tokens"]:
            raise AssertionError(f"[cim chunked {layout}] prefix cache on "
                                 "and off give other tokens")
        if not stats["hits"] or stats["verify_failures"]:
            raise AssertionError(f"[cim chunked {layout}] prefix stats "
                                 f"{stats}")
        if (on["line"]["prefill_chunk_steps"]
                >= off["line"]["prefill_chunk_steps"]):
            raise AssertionError(f"[cim chunked {layout}] the prefix cache "
                                 "saved no chunk")
        if {k for k, v in launches[layout].items() if v} != own[layout]:
            raise AssertionError(f"[cim chunked {layout}] launches "
                                 f"{launches[layout]}, want {own[layout]}")
        for v in on["tokens"]:
            if len(v) != CHUNK_TOKENS or not all(0 <= t < cfg.vocab_size
                                                 for t in v):
                raise AssertionError(f"[cim chunked {layout}] served tokens")
    eager = runs["legacy", True, False]
    if eager["tokens"] != runs["legacy", True, True]["tokens"]:
        raise AssertionError("[cim chunked legacy] eager and captured runs "
                             "give other tokens")
    ref = _legacy_decode_vs_ref(cfg, params, ctx, eager.pop("engine"))
    steps = profile_layout_steps(cfg, params, ctx)
    return {"launches": launches["fused"], "legacy_launches":
            launches["legacy"],
            "lines": {f"{lay} {'on' if c else 'off'}"
                      f"{'' if g else ' eager'}": r["line"]
                      for (lay, c, g), r in runs.items()},
            "legacy_vs_ref": ref, "steps": steps}


def _legacy_decode_vs_ref(cfg, params, ctx, eng) -> dict:
    """One decode step through ``lm.decode_step`` on four pages of a legacy
    pool after its serve (each slot's last request: its last token at its
    next position), gathered twice: the kernels' run against
    ``impl="ref"`` (the reference's compositions; ``cim_linear`` is
    bitwise its plain version and the legacy decode is torch ops either
    way). SQNR >= 30 dB; printed with whether the logits are bitwise."""
    from repro_torch.models import lm
    from repro_torch.serving.kvcache import gather_rows

    lanes, seen = [], set()
    for rid in sorted(eng.requests, reverse=True):  # the latest a slot
        req = eng.requests[rid]
        if req.slot not in seen and len(lanes) < 4:
            seen.add(req.slot)
            lanes.append(req)
    dev = params["embed"]["emb"].device
    rows = torch.tensor([r.slot for r in lanes], device=dev)
    ids = torch.tensor([[r.out[-1]] for r in lanes], device=dev)
    pos = torch.tensor([len(r.prompt) + len(r.out) - 1 for r in lanes],
                       device=dev)
    logits = {}
    with torch.no_grad():
        for impl in ("auto", "ref"):
            caches = gather_rows(eng.kv.pool, eng.kv.specs, rows)
            logits[impl], _ = lm.decode_step(
                params, cfg, dataclasses.replace(ctx, impl=impl, obs=None),
                ids, pos, caches)
    sq = _sqnr_db(logits["ref"].float(), logits["auto"].float())
    line = {"backend": "cim", "kv_layout": "legacy", "lanes": len(lanes),
            "positions": pos.tolist(), "sqnr_db": sq,
            "bitwise": bool(torch.equal(logits["auto"], logits["ref"])),
            "finite": bool(torch.isfinite(logits["auto"].float()).all())}
    print("legacy decode vs impl=ref", json.dumps(line), flush=True)
    if not line["finite"] or sq < 30.0:
        raise AssertionError(f"[cim legacy] decode logits vs impl=ref: {line}")
    return line


def profile_layout_steps(cfg, params, ctx, steps: int = 8) -> dict:
    """The decode and chunk steps of a captured ``CHUNK_ECFG`` engine on a
    fused and on a legacy pool, in this call: 4 requests whose prompts
    fill the page to ``LAYOUT_LENGTHS`` slots decode under the profiler
    (``steps`` steps, then as many unprofiled for the wall), then the
    chunk step (a 256-token window at ``LAYOUT_CHUNK_AT`` of a free page,
    replayed on one input: idempotent) likewise. Prints a ``layout steps`` line
    with device and wall ms a step by layout, and the bytes a legacy
    decode step's gather and scatter move (the lanes' page rows read and
    written twice) over 3.35 TB/s."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving import engine as eng_mod

    lens, at = LAYOUT_LENGTHS, LAYOUT_CHUNK_AT
    L = CHUNK_ECFG["chunk_len"]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    window = rng.integers(0, cfg.vocab_size, L).tolist()
    out = {}
    for layout in ("fused", "legacy"):
        eng = Engine(params, cfg, dataclasses.replace(ctx, obs=None),
                     EngineConfig(**(CHUNK_ECFG | {"kv_layout": layout})))
        for p in prompts:
            eng.add_request(p, max_new=CHUNK_ECFG["page_len"] - max(lens))
        while len(eng.sched.running) < len(lens):
            eng.step()
        eng.step()  # a decode step outside the window
        page = CHUNK_ECFG["page_len"]
        dec = _profiled(f"decode profile {layout} W={page}", ctx, steps,
                        eng.step, attempts=2)
        _unprofiled(dec, steps, eng.step, len(lens))
        row = eng.kv.allocator.alloc()  # a free page for the chunk
        host = eng._host["chunk"].numpy()
        eng_mod._window(host, L, window, at)
        host[2 * L:] = (row, L - 1, at)

        def chunk():
            eng._call("chunk").cpu()  # ends in the host read, as a step

        chunk()  # replays of the captured chunk graph from here
        ch = _profiled(f"chunk profile {layout} W={page}", ctx, 4, chunk,
                       attempts=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            chunk()
        ch["wall_ms"] = (time.perf_counter() - t0) * 1e3 / 4
        rows_bytes = sum(v[0].numel() * v.element_size() * len(lens)
                         for seg in eng.kv.pool for layer in seg
                         for v in layer.values())
        out[layout] = {
            "decode": {k: dec.get(k) for k in (
                "device_ms_per_step", "wall_ms", "busy_share", "tok_s",
                "timer")} | {"launches_a_step": {
                    k: v / steps for k, v in dec["launches"].items()}},
            "chunk": {"device_ms": ch["device_ms_per_step"],
                      "wall_ms": ch["wall_ms"], "timer": ch["timer"],
                      "launches": {k: v / 4 for k, v in
                                   ch["launches"].items()}},
            "lane_pages_mib": rows_bytes / 2**20}
        if layout == "legacy":
            moved = 4 * rows_bytes  # gather: read + write; scatter: same
            out[layout]["gather_scatter_bytes"] = moved
            out[layout]["gather_scatter_bound_ms"] = moved / HBM_BYTES_S * 1e3
        del eng
    print("layout steps", json.dumps({"backend": "cim",
                                      "layers": cfg.n_layers,
                                      "page_len": CHUNK_ECFG["page_len"],
                                      "lengths": list(lens)} | out),
          flush=True)
    if out["legacy"]["decode"]["launches_a_step"] != {
            "cim_linear": 6 * cfg.n_layers + 1}:
        raise AssertionError(f"[cim legacy] a decode step launched "
                             f"{out['legacy']['decode']['launches_a_step']}")
    return out


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


def _matmul_routes(backend: str, shapes) -> dict:
    """Launches by route of the backend's matmul kernel over ``shapes``
    ((M, K, N, x dtype) a launch), each on the route its picker takes."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    routes: dict = {}
    for m, k, n, dtype in shapes:
        r = (cim_ops.pick_route(m, k, n) if backend == "cim"
             else mm_ops.pick_route(m, k, n, dtype))
        routes[r] = routes.get(r, 0) + 1
    return routes


def _vit_trunk_shapes(cfg, rows: int) -> list:
    """The six linears of every encoder layer at ``rows`` rows."""
    d, f, bf16 = cfg.d_model, cfg.d_ff, torch.bfloat16
    return cfg.n_layers * ([(rows, d, d, bf16)] * 4
                           + [(rows, d, f, bf16), (rows, f, d, bf16)])


def _vit_routes(cfg, backend: str) -> dict:
    """Launches by route that one frame of ``cfg`` must make: the patch
    embedding (f32 x), six linears a layer at a frame's rows and the
    classifier over the CLS row, each on the route its picker takes."""
    return _matmul_routes(
        backend, [(cfg.n_patches, cfg.patch_dim, cfg.d_model, torch.float32)]
        + _vit_trunk_shapes(cfg, cfg.seq_len)
        + [(1, cfg.d_model, cfg.n_classes, torch.bfloat16)])


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

    calib = ["--calib-batches", str(VISION_CALIB_BATCHES[arch])] \
        if arch in VISION_CALIB_BATCHES else []
    args = serve.build_parser().parse_args(
        ["--arch", arch, "--backend", backend] + VISION_ARGS + calib)
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
    """``WINDOW_FRAMES`` single-stream frames (``VISION_WINDOW_FRAMES``
    for a cut arch) under ``torch.profiler``,
    eager (``cuda_graphs=False``) and captured (the first frame, outside
    the window, captures the chain): device time, wall time and busy
    share a frame, ``fps_host`` of the window, the capture's seconds and
    the graphs' pool bytes (summed over the chain). The window's logits
    must be bitwise equal between the two."""
    from repro_torch.serving import VisionEngine

    window = VISION_WINDOW_FRAMES.get(arch, WINDOW_FRAMES)
    gen = torch.Generator(device=params["pos"].device).manual_seed(22)
    frames = torch.randn((window, cfg.image_size, cfg.image_size,
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
        prof = _profiled(f"frame profile {arch} {mode}", ctx, window,
                         lambda: eng.classify_frame(next(nxt)), attempts=1)
        _unprofiled(prof, window, lambda: eng.classify_frame(next(nxt)), 1)
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
        {"backend": ctx.quant, "model": cfg.name, "frames": window,
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
    """Launches by kernel, the matmul kernels' launches by route (by
    kernel: ``cim_linear`` and ``mxfp4_matmul``) and ``flash_attention``'s
    by route that ``prefills`` [1, prefill_len] prefills (the layers'
    linears at prefill_len rows, an untied head at the last row) and
    ``decodes`` [lanes, 1] decode steps of ``cfg`` make: a linear is the
    backend's kernel's where the conversion packs it (K % 32 == 0, N >=
    ``min_n``); an MoE layer's expert products are ``mxfp4_matmul``'s
    under both backends, one launch an expert a bank at M = the step's
    capacity (``layers/moe.py::capacity`` of its rows); one paged decode a
    layer a step, and, under mxfp4 past ``attn_max``, one
    ``flash_attention`` a layer a prefill (under cim the digital SDPA is
    torch ops)."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.layers import ffn
    from repro_torch.layers import moe

    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    glu = cfg.ffn_kind in ffn.GLU_KINDS
    ffn_shapes = [(d, f)] * (1 + glu) + [(f, d)]
    layer = ([(d, cfg.n_heads * hd)] + [(d, cfg.n_kv_heads * hd)] * 2
             + [(cfg.n_heads * hd, d)]
             + ([] if cfg.n_experts else ffn_shapes))
    head = [] if cfg.tie_embeddings else [(d, cfg.vocab_size)]
    body = layer * cfg.n_layers
    kern = VISION_KERNEL[backend]
    routes: dict = {"cim_linear": {}, "mxfp4_matmul": {}}
    for m, times, shapes in ((prefill_len, prefills, body), (1, prefills, head),
                             (lanes, decodes, body + head)):
        for k, n in shapes:
            if k % 32 or n < min_n:
                continue
            r = (cim_ops.pick_route(m, k, n) if backend == "cim"
                 else mm_ops.pick_route(m, k, n, torch.bfloat16))
            routes[kern][r] = routes[kern].get(r, 0) + times
        if cfg.n_experts and shapes is not head:
            cap = moe.capacity(m, cfg.top_k, cfg.n_experts,
                               cfg.capacity_factor)
            for k, n in ffn_shapes:
                r = mm_ops.pick_route(cap, k, n, torch.bfloat16)
                routes["mxfp4_matmul"][r] = (routes["mxfp4_matmul"].get(r, 0)
                                             + times * cfg.n_experts
                                             * cfg.n_layers)
    launches = dict.fromkeys(_kernel_wrappers(), 0)
    for name, by_route in routes.items():
        launches[name] = sum(by_route.values())
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


def _dense_decode(cfg, params, ctx, ids, caches,
                  steps: int = DENSE_STEPS) -> list:
    """Logits of ``steps`` teacher-forced decode steps after
    :func:`_dense_prefill`, on a copy of its page."""
    from repro_torch.models import lm

    caches = [[{k: v.clone() for k, v in layer.items()} for layer in seg]
              for seg in caches]
    out = []
    with torch.no_grad():
        for p in range(DENSE_PROMPT, DENSE_PROMPT + steps):
            lo, caches = lm.decode_step(params, cfg, ctx, ids[:, p:p + 1], p,
                                        caches)
            out.append(lo.float())
    return out


@contextlib.contextmanager
def _moe_hooks(log: list, follow: list | None = None,
               experts_on_c: bool = False):
    """Record every MoE routing decision (``layers/moe.py::route``'s
    gates and expert ids) into ``log`` while the block runs; with
    ``follow`` (another run's log, call for call) each call still records
    its own decision but returns ``follow``'s, so two runs compare their
    numerics on one routing. With ``experts_on_c`` the expert products of
    a packed bank launch kernel C under ``impl="ref"`` too. The caller
    holds the hooks to having run: ``log``'s length, and C's counter."""
    from repro_torch.layers import moe

    route, products = moe.route, moe.expert_matmul

    def logged(xn, router_w, top_k):
        out = route(xn, router_w, top_k)
        log.append(out)
        return out if follow is None else follow[len(log) - 1]

    def on_c(ctx, h, bank):
        return products(dataclasses.replace(ctx, impl="auto"), h, bank)

    moe.route = logged
    if experts_on_c:
        moe.expert_matmul = on_c
    try:
        yield
    finally:
        moe.route, moe.expert_matmul = route, products


def _routing_flips(a: list, b: list) -> tuple[int, int]:
    """(rows whose chosen experts differ, rows) between two runs' logs."""
    flips = sum(int((torch.sort(x[1], -1).values
                     != torch.sort(y[1], -1).values).any(-1).sum())
                for x, y in zip(a, b))
    return flips, sum(x[1].shape[0] for x in a)


def serve_dense(arch: str, backend: str, layers: int | None = None,
                steps: int = DENSE_STEPS, dense_ref: bool = True,
                extra=None) -> dict:
    """Phase 9 and phase 11, one run: ``arch`` at full width, and at full
    depth unless ``layers`` (phase 9: ``DENSE_LAYERS``) cuts it, through
    the launcher's ``build_model`` and ``serve_trace`` (``DENSE_ARGS``),
    every step captured. The launches by kernel and route must be exactly
    ``_dense_launches``'s for the serve's prefills and decode steps. Then
    logits of a 384-token prefill and ``steps`` decode steps against
    ``impl="ref"`` with the chunked plain decode (SQNR >= 30 dB; with
    ``dense_ref`` the dense ``impl="ref"`` figure is printed beside it; an
    MoE model's ``impl="ref"`` run follows the kernel run's routing, the
    decisions of its own that differ are counted, and its prefill on its
    own routing is printed; under ``cim`` its expert products stay on
    kernel C), each request served alone giving its first ``SOLO_TOKENS``
    staggered tokens bitwise (not for an MoE model: a token's expert
    slots depend on its step's other rows), the tied head's time
    (gemma3-1b), ``extra(cfg, params, kernel ctx, ref ctx)``'s checks
    (their dict joins the line), one prefill under the profiler and 8
    decode steps under it eager and captured (tokens bitwise between the
    two). Peak memory is printed for the build and for the serve."""
    from repro_torch import configs as C
    from repro_torch import obs as obs_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.launch import serve
    from repro_torch.layers import ffn as ffn_mod
    from repro_torch.models import lm
    from repro_torch.serving import Engine

    if layers is None:
        layers = DENSE_LAYERS.get((arch, backend), DENSE_LAYERS.get(arch, 0))
    args = serve.build_parser().parse_args(
        ["--arch", arch, "--backend", backend, "--layers", str(layers)]
        + DENSE_ARGS)
    obs = obs_lib.Obs()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_model(args, obs=obs)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    resident = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe_txt = (f", {cfg.n_experts} experts top-{cfg.top_k} capacity factor "
               f"{cfg.capacity_factor}" if cfg.n_experts else "")
    print(f"[{backend}] {cfg.name}: full width, {cfg.n_layers} of "
          f"{C.ARCHS[arch].n_layers} layers (d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff} "
          f"{cfg.ffn_kind}{moe_txt}, vocab {cfg.vocab_size}, M-RoPE "
          f"{cfg.mrope}, segments "
          f"{[(s.kind, s.n, s.attn.window) for s in lm.build_segments(cfg)]})"
          f"; build peak {build_peak / 2**30:.2f} GiB, resident "
          f"{resident / 2**30:.2f} GiB", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    summary = serve.serve_trace(args, cfg, params, ctx, obs, dev)
    launches, mm_routes = _read_counts()
    routes = {"cim_linear": _cim_routes(), "mxfp4_matmul": mm_routes}
    routes = {k: {r: n for r, n in v.items() if n} for k, v in routes.items()}
    fa_routes = dict(fa_ops.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    ecfg = summary["ecfg"]
    want, want_routes, want_fa = _dense_launches(
        cfg, backend, len(summary["out"]), summary["decode_steps"],
        ecfg.prefill_len, ecfg.lanes, ctx.dense_attn_max, args.cim_min_n)
    exact = (launches == want and fa_routes == want_fa
             and routes == want_routes)
    for v in summary["out"].values():
        if len(v) != DENSE_TOKENS or not all(0 <= t < cfg.vocab_size
                                              for t in v):
            raise AssertionError(f"[{backend} {arch}] served tokens {v}")
    # logits: kernels vs impl="ref" with the chunked plain decode
    t1 = time.perf_counter()
    ids = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT + steps),
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(14))
    kctx = dataclasses.replace(ctx, obs=None)
    rctx = dataclasses.replace(kctx, impl="ref")
    # an MoE model's impl="ref" run takes the kernel run's routing (its
    # own decisions are counted): kernel C's f32 sums round other bf16
    # outputs than the einsum's, and a near tie in a router then picks
    # another expert for the token, which no tolerance of the numerics
    # covers. Under cim its expert products stay on kernel C as well: the
    # next layer's analog inputs are MXFP4 codes, and one bf16 ulp that
    # moves a code grows through the layers (two roundings of the
    # einsum itself land ~15 dB apart in the logits), so the run holds A,
    # B and the rest of the path to 30 dB on C's products, and C is held
    # to the composition by the `moe layer` check and its kernel rows
    moe_layers = cfg.n_layers if cfg.n_experts else 0
    on_c = moe_layers > 0 and backend == "cim"
    banks = 3 if cfg.ffn_kind in ffn_mod.GLU_KINDS else 2
    klog, rlog, olog = [], [], []
    with _moe_hooks(klog):
        lo, caches = _dense_prefill(cfg, params, kctx, ids)
        got = [lo] + _dense_decode(cfg, params, kctx, ids, caches, steps)
    c_before = mm_ops.mxfp4_matmul.launches
    with _moe_hooks(rlog, follow=klog if moe_layers else None,
                    experts_on_c=on_c):
        lo, caches = _dense_prefill(cfg, params, rctx, ids)
        with _chunked_ref_decode():
            ref = [lo] + _dense_decode(cfg, params, rctx, ids, caches, steps)
    ref_c = mm_ops.mxfp4_matmul.launches - c_before
    flips, decisions = _routing_flips(klog, rlog)
    own_routing = None
    if moe_layers:  # the prefill on the impl="ref" run's own routing
        with _moe_hooks(olog, experts_on_c=on_c):
            own_routing = _sqnr_db(_dense_prefill(cfg, params, rctx, ids)[0],
                                   got[0])
    hooks = {"routes": [len(klog), len(rlog), len(olog)],
             "want_routes": [moe_layers * (1 + steps)] * 2 + [moe_layers],
             "ref_c_launches": ref_c,
             "want_ref_c_launches": (banks * cfg.n_experts * moe_layers
                                     * (1 + steps) if on_c else 0)}
    hooked = (hooks["routes"] == hooks["want_routes"]
              and (not moe_layers or ref_c == hooks["want_ref_c_launches"]))
    dense = ([lo] + _dense_decode(cfg, params, rctx, ids, caches, steps)
             if dense_ref else [])
    del lo, caches, klog, rlog, olog
    sq = [_sqnr_db(r, g) for r, g in zip(ref, got)]
    sq_dense = [_sqnr_db(r, g) for r, g in zip(dense, got)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    routing = (", the kernels' routing" + (", experts on C" if on_c else "")
               if moe_layers else "")
    print(f"[{backend} {arch}] logits of a {DENSE_PROMPT}-token prefill and "
          f"{steps} decode steps, kernels vs impl=ref (chunked plain "
          f"decode{routing}): "
          f"SQNR {sq} dB; vs impl=ref (dense decode) "
          f"{sq_dense or 'not run'} dB; routing decisions that differ "
          f"{flips} of {decisions}; the prefill vs impl=ref on its own "
          f"routing {own_routing} dB; hooks {hooks}; finite {finite}",
          flush=True)
    del got, ref, dense
    check_s = time.perf_counter() - t1
    # each request alone, through an engine of the serve's config: its
    # first SOLO_TOKENS greedy tokens, which a longer solo run repeats
    t1 = time.perf_counter()
    solo_diff = None
    if not cfg.n_experts:
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
    more = extra(cfg, params, kctx, rctx) if extra else {}
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
            "routing_flips": flips, "routing_decisions": decisions,
            "prefill_sqnr_own_routing_db": own_routing,
            "ref_experts_on_c": on_c, "moe_hooks": hooks,
            "staggered_equals_solo": (None if solo_diff is None
                                      else not solo_diff),
            "solo_s": solo_s, "logits_check_s": check_s,
            "tied_head": head, **more, "peak_mem_gib": peak / 2**30,
            "build_peak_mem_gib": build_peak / 2**30,
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
    if not hooked:
        raise AssertionError(f"[{backend} {arch}] the MoE hooks did not run "
                             f"as counted: {hooks}")
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


def check_moe_kernels(dev) -> dict:
    """Phase 11's kernel rows, each against its plain version as in phase
    3: ``mxfp4_matmul`` on one expert's slice of a packed bank at the
    expert products' shapes (mixtral-8x22b's w1 / w3 [cap, 6144] x [6144,
    16384] and w2 [cap, 16384] x [16384, 6144], qwen3-moe-235b-a22b's
    [cap, 4096] x [4096, 1536] and [cap, 1536] x [1536, 4096], at the
    capacity of a 4-lane decode step and of a [1, 384] prefill), the
    library call ``torch.matmul`` on the slice dequantized to bf16;
    ``cim_linear`` at the two MoE archs' analog linears (wq, wk / wv, wo
    at M = 4 and M = 384, the untied head at a decode step's 4 rows);
    ``paged_decode_mx`` and ``paged_decode`` at G 16 and G 7
    (``MOE_DECODE_DIMS``, page 448). Rows by kernel name; each names its
    arch (``case``)."""
    from repro_torch import configs as C
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.layers import backends
    from repro_torch.layers import moe

    rows: dict = {"mxfp4_matmul": [], "cim_linear": [],
                  "paged_decode_mx": [], "paged_decode": []}
    gen = torch.Generator(device=dev).manual_seed(11)
    ccfg = cimlib.CIMConfig()
    for arch in ("mixtral-8x22b", "qwen3-moe-235b-a22b"):
        cfg = C.ARCHS[arch]
        caps = [moe.capacity(m, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
                for m in (4, DENSE_PROMPT)]
        for bank, (k, n) in (("w1/w3", (cfg.d_model, cfg.d_ff)),
                             ("w2", (cfg.d_ff, cfg.d_model))):
            packed = backends.quantize_bank(
                torch.randn((2, k, n), generator=gen, device=dev) * k ** -0.5)
            codes, exps = packed["codes"][1], packed["exps"][1]
            w_bf16 = backends._dequant_packed(codes, exps)  # library operand
            for cap in caps:
                x = torch.randn((cap, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                rows["mxfp4_matmul"].append(_mxfp4_row(
                    x, codes, exps, w_bf16, {"case": arch, "bank": bank}))
            del packed, codes, exps, w_bf16
        d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        linears = {"wq": (d, q), "wk/wv": (d, kv), "wo": (q, d),
                   "head": (d, cfg.vocab_size)}
        for name, (k, n) in linears.items():
            if name == "wo" and (k, n) == linears["wq"]:
                continue  # mixtral's wo is wq's shape
            w = mxlib.quantize_w(torch.randn((k, n), generator=gen,
                                             device=dev) * k ** -0.5)
            for m in (4,) if name == "head" else (4, DENSE_PROMPT):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16).float()
                rows["cim_linear"].append(_cim_row(
                    x, w, cimlib.calibrate_rowhist([x], w, ccfg), ccfg,
                    {"case": arch, "linear": name}))
            del w
    for arch, dims in MOE_DECODE_DIMS.items():
        extra, pages = {"case": arch}, ((DENSE_PAGE, DENSE_LENGTHS),)
        rows["paged_decode_mx"] += check_paged_decode(dev, dims, pages, extra)
        rows["paged_decode"] += check_paged_decode_float(dev, dims, pages,
                                                         extra)
    return rows


def _captured_logits(cfg, params, ctx) -> dict:
    """A [1, 384] prefill into a fused page and one decode step after it,
    each run eagerly and as a captured ``StepGraph`` on the same input:
    whether the logits are bitwise equal (each step rewrites the page rows
    it reads, so a replay sees what the eager run saw)."""
    from repro_torch.models import lm
    from repro_torch.serving import graphs

    dev = params["final_ln"]["gamma"].device
    ids = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(21))
    caches = lm.init_cache(cfg, 1, DENSE_PAGE, fused=True, device=dev,
                           mx_digital=ctx.hybrid_digital_sdpa)
    # positions on the device, as the engine's steps take them: a graph
    # captures no copy from the host
    positions = torch.arange(DENSE_PROMPT, device=dev)[None]
    pos = torch.full((1,), DENSE_PROMPT, device=dev)
    pctx = dataclasses.replace(ctx, arange_positions=True)

    def prefill(t):
        return lm.forward(params, cfg, pctx, {"ids": t, "positions": positions},
                          caches=caches)[0]

    def decode(t):
        return lm.decode_step(params, cfg, ctx, t, pos, caches)[0]

    out = {}
    with torch.no_grad():
        for name, fn, inp in (("prefill", prefill, ids[:, :DENSE_PROMPT]),
                              ("decode", decode, ids[:, DENSE_PROMPT:])):
            inp = inp.clone()
            eager = fn(inp).clone()
            out[name] = bool(torch.equal(graphs.StepGraph(fn, inp)(), eager))
    if not all(out.values()):
        raise AssertionError(f"[{ctx.quant} {cfg.name}] captured logits are "
                             f"not the eager ones: {out}")
    return out


def moe_layer_check(cfg, params, kctx, rctx) -> dict:
    """Phase 11, an MoE model: its first layer's MoE sublayer at a decode
    step's 4 rows, timed two ways: through kernel C (``3E`` launches,
    which must move its counter by exactly that; eagerly, and as one
    captured graph, ``captured_ms``, bitwise the eager output) and as the
    reference composes it (``impl="ref"``: each bank dequantized whole to bf16, then
    the einsum), its output against the kernel's (SQNR >= 30 dB); the
    composition's expert products alone (three banks dequantized, three
    bf16 einsums, ``compose_ms``); the host wall of one eager call (the
    ``3E`` launches' dispatch and the routing's torch ops,
    ``eager_wall_ms``), beside the bound (the three packed banks read
    once). Then the captured prefill and decode logits against the eager
    ones (:func:`_captured_logits`). Prints a ``moe layer`` line."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.layers import backends
    from repro_torch.layers import ffn
    from repro_torch.layers import moe
    from repro_torch.serving import graphs

    p = params["segments"][0][0]["moe"]
    dev = p["router"]["w"].device
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((4, 1, d), generator=gen, device=dev).to(torch.bfloat16)

    def run(ctx):
        return moe.moe_apply(ctx, cfg.ffn_kind, cfg.norm, p, x, cfg.top_k,
                             cfg.capacity_factor)

    with torch.no_grad():
        before = mm_ops.mxfp4_matmul.launches
        got = run(kctx)
        per_call = mm_ops.mxfp4_matmul.launches - before
        ref = run(rctx)
        sq = _sqnr_db((ref - x).float(), (got - x).float())
        names = [n for n in ("w1", "w3", "w2") if n in p]
        cap = moe.capacity(4, cfg.top_k, e, cfg.capacity_factor)
        buf = torch.randn((e, cap, d), generator=gen, device=dev).to(
            torch.bfloat16)
        hid = torch.randn((e, cap, f), generator=gen, device=dev).to(
            torch.bfloat16)

        def compose():
            for name in names:
                w = backends._dequant_packed(p[name]["codes"],
                                             p[name]["exps"])
                torch.einsum("ecd,edf->ecf", hid if name == "w2" else buf, w)

        kernel_ms = _device_ms(lambda: run(kctx), 10)
        # the layer as a served step runs it: one captured graph, timed
        # with events around each replay (no host dispatch between its
        # launches)
        graph = graphs.StepGraph(
            lambda t: moe.moe_apply(kctx, cfg.ffn_kind, cfg.norm, p, t,
                                    cfg.top_k, cfg.capacity_factor), x)
        graph()
        captured_ms = _time_ms(graph, 20)
        if not torch.equal(graph(), got):
            raise AssertionError(f"[{kctx.quant} {cfg.name}] the captured "
                                 "MoE layer is not the eager one")
        del graph
        ref_ms = _device_ms(lambda: run(rctx), 3)
        compose_ms = _device_ms(compose, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run(kctx)
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    bank_bytes = sum(p[n][leaf].numel() for n in names
                     for leaf in ("codes", "exps"))
    bound, by = _bound_ms(bank_bytes + 2 * 2 * x.numel(),
                          2.0 * e * cap * d * f * len(names), "bf16")
    line = {"model": cfg.name, "backend": kctx.quant, "rows": 4,
            "experts": e, "top_k": cfg.top_k, "cap": cap,
            "glu": cfg.ffn_kind in ffn.GLU_KINDS,
            "kernel_launches": per_call, "want_launches": len(names) * e,
            "sqnr_vs_ref_db": sq, "kernel_ms": kernel_ms,
            "captured_ms": captured_ms, "ref_ms": ref_ms,
            "compose_ms": compose_ms, "eager_host_ms": host_ms,
            "eager_wall_ms": wall_ms, "bound_ms": bound, "bound_by": by,
            "bank_gib": bank_bytes / 2**30}
    print("moe layer", json.dumps(line), flush=True)
    if per_call != len(names) * e or sq < 30.0:
        raise AssertionError(f"[{kctx.quant} {cfg.name}] MoE layer: {line}")
    return {"moe_layer": line,
            "captured_logits_bitwise": _captured_logits(cfg, params, kctx)}


def vlm_vision_check(cfg, params, kctx, rctx) -> dict:
    """Phase 11, qwen2-vl-7b: a [1, 384] prefill whose first
    ``VIS_TOKENS`` embeddings come from ``vis_emb`` [1, 64, 1176] through
    ``front_proj`` (K = 1176, not 32-aligned: a float linear under every
    backend), through ``lm.forward``: logits against ``impl="ref"`` (SQNR
    >= 30 dB), finite, and unlike the text-only prefill's in the vision
    rows. Then the captured prefill and decode logits against the eager
    ones (:func:`_captured_logits`)."""
    from repro_torch.models import lm

    dev = params["final_ln"]["gamma"].device
    gen = torch.Generator(device=dev).manual_seed(23)
    ids = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT), device=dev,
                        generator=gen)
    vis = torch.randn((1, VIS_TOKENS, cfg.frontend_dim), generator=gen,
                      device=dev)
    with torch.no_grad():
        got = lm.forward(params, cfg, kctx, {"ids": ids, "vis_emb": vis})[0]
        ref = lm.forward(params, cfg, rctx, {"ids": ids, "vis_emb": vis})[0]
        text = lm.forward(params, cfg, kctx, {"ids": ids})[0]
    out = {"vis_emb": list(vis.shape),
           "front_proj": sorted(params["front_proj"]),
           "sqnr_db": _sqnr_db(ref.float(), got.float()),
           "finite": bool(torch.isfinite(got.float()).all()),
           "vision_rows_differ": not torch.equal(got[:, :VIS_TOKENS],
                                                 text[:, :VIS_TOKENS]),
           "text_rows_sqnr_vs_text_only_db": _sqnr_db(
               text[:, VIS_TOKENS:].float(), got[:, VIS_TOKENS:].float())}
    print(f"[{kctx.quant} {cfg.name}] vision prefill", json.dumps(out),
          flush=True)
    if out["sqnr_db"] < 30.0 or not out["finite"] or not out[
            "vision_rows_differ"]:
        raise AssertionError(f"[{kctx.quant}] vision prefill: {out}")
    return {"vision_prefill": out,
            "captured_logits_bitwise": _captured_logits(cfg, params, kctx)}


def serve_moe_vlm(arch: str, backend: str) -> dict:
    """Phase 11, one run: phase 9's serve (:func:`serve_dense`) of ``arch``
    at full width and ``MOE_LAYERS`` layers, ``MOE_STEPS`` decode steps
    held to ``impl="ref"`` (routing flips counted), with the MoE layer's
    or the vision prefill's checks."""
    check = vlm_vision_check if arch == "qwen2-vl-7b" else moe_layer_check
    layers = MOE_LAYERS.get((arch, backend), MOE_LAYERS[arch])
    return serve_dense(arch, backend, layers=layers,
                       steps=MOE_STEPS, dense_ref=False, extra=check)


def moe_kernel_entries(moe_rows: dict, runs: dict) -> list:
    """The kernels line's entries of phase 11: ``mxfp4_matmul`` at the
    expert shapes (launches: the mxfp4 serve of that arch), ``cim_linear``
    at the MoE archs' analog linears and the decode kernels at G 16 and
    G 7 (launches: the serve that runs them)."""
    out = []
    for name, replaces, run in (
            ("mxfp4_matmul", "src/repro/kernels/mxfp4_matmul/kernel.py:69",
             "mxfp4"),
            ("cim_linear", "src/repro/kernels/cim_linear/kernel.py:127",
             "cim"),
            ("paged_decode_mx",
             "src/repro/kernels/paged_attention/kernel.py:275", "cim"),
            ("paged_decode",
             "src/repro/kernels/paged_attention/kernel.py:228", "mxfp4")):
        for row in moe_rows[name]:
            shape = (f"M={row['m']} K={row['k']} N={row['n']} (expert "
                     f"{row['bank']}, cap {row['m']})"
                     if name == "mxfp4_matmul" else
                     f"M={row['m']} K={row['k']} N={row['n']} "
                     f"({row['linear']})" if name == "cim_linear" else
                     f"L={row['lanes']} Hkv={row['hkv']} G={row['g']} "
                     f"Dh={row['dh']} W={row['w']} lengths {row['lengths']}")
            out.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": runs[f"moe {row['case']} {run}"]["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"),
                "call_ms": row["call_ms"], "kernel_route": row.get("route"),
                "shape": f"{shape} ({row['case']})"})
    return out


def _converted_paths(tree, marker: str) -> list:
    """Calibration paths (``segments/<i>/L<j>/...``) of the converted
    linears of ``tree``: nodes holding ``marker`` (``e_n``: analog,
    ``codes``: packed MXFP4)."""
    from repro_torch.layers.backends import layer_paths

    out = []

    def rec(node, path):
        if isinstance(node, dict):
            if marker in node:
                out.append(path)
                return
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else k)
        elif isinstance(node, list):
            paths = (layer_paths(path, len(node))
                     if path.startswith("segments/")
                     else [f"{path}/{i}" if path else str(i)
                           for i in range(len(node))])
            for v, p in zip(node, paths):
                rec(v, p)

    rec(tree, "")
    return out


def check_fidelity_linears(dev) -> list:
    """Phase 10's kernel level: on each of ``FID_LINEARS`` with a Row-Hist
    calibration taken on the card, and again at ``FID_MISCAL`` times its
    full scale, ``cim_linear_fidelity``'s ``y`` (torch ops on the card)
    must be ``torch.equal`` to the ``cim_linear`` kernel's output on the
    route the shape picks, and its statistics (alignment counts, both
    passes' saturation and code occupancy, ``live_e_max``, ``live_fs``)
    equal to a CPU run of the same function on the same tensors; then
    ``quant_health`` on the card equals its CPU run. A ``fidelity linear``
    line a row."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.obs import EXP_BUCKETS, RATIO_BUCKETS
    from repro_torch.obs.fidelity import _to_host

    gen = torch.Generator(device=dev).manual_seed(10)
    cfg = cimlib.CIMConfig()
    cpu = torch.device("cpu")
    rows, weights, xs = [], {}, []
    for m, k, n in FID_LINEARS:
        if (k, n) not in weights:
            weights[(k, n)] = mxlib.quantize_w(
                torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        w = weights[(k, n)]
        w_cpu = mxlib.MXW(w.codes.to(cpu), w.exps.to(cpu))
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        xs.append(x)
        cal = cimlib.calibrate_rowhist([x], w, cfg)
        route = cim_ops.pick_route(m, k, n)
        for scale in (1.0, FID_MISCAL):
            c = cal._replace(adc_fs=cal.adc_fs * scale)
            before = cim_ops.cim_linear.route_launches[route]
            got = cim_ops.cim_linear(x, w, c, cfg=cfg)
            if cim_ops.cim_linear.route_launches[route] != before + 1:
                raise AssertionError(f"fidelity linear {(m, k, n)}: the "
                                     f"kernel did not take {route}")
            y, st = cimlib.cim_linear_fidelity(x, w, cfg, c, RATIO_BUCKETS)
            t0 = time.perf_counter()
            y_cpu, st_cpu = cimlib.cim_linear_fidelity(
                x.to(cpu), w_cpu, cfg,
                cimlib.LayerCalib(c.e_n.to(cpu), c.adc_fs.to(cpu)),
                RATIO_BUCKETS)
            cpu_s = time.perf_counter() - t0
            st, st_cpu = _to_host(st), _to_host(st_cpu)
            same = {key: bool(np.array_equal(st[key], st_cpu[key]))
                    for key in ("counts", "live_e_max", "live_fs")}
            for p in ("pass1", "pass2"):
                for key in ("saturated", "occ_counts", "peak"):
                    same[f"{p}.{key}"] = bool(np.array_equal(
                        st[p][key], st_cpu[p][key]))
            row = dict(
                m=m, k=k, n=n, route=route, adc_fs_scale=scale,
                y_equal_kernel=bool(torch.equal(y, got)),
                y_equal_cpu=bool(torch.equal(y.to(cpu), y_cpu)),
                stats_equal_cpu=all(same.values()),
                counts=[int(v) for v in st["counts"]],
                saturated=[int(st[p]["saturated"]) for p in ("pass1",
                                                            "pass2")],
                samples=int(st["pass1"]["total"]) * 2,
                live_e_max=int(st["live_e_max"]), e_n=int(c.e_n),
                live_fs=float(st["live_fs"]), adc_fs=float(c.adc_fs),
                kernel_ms=_time_ms(lambda: cim_ops.cim_linear(
                    x, w, c, cfg=cfg), 3, warm=1),
                fidelity_ms=_time_ms(lambda: cimlib.cim_linear_fidelity(
                    x, w, cfg, c, RATIO_BUCKETS), 3, warm=1),
                cpu_s=cpu_s)
            print("fidelity linear", json.dumps(row), flush=True)
            if not (row["y_equal_kernel"] and row["y_equal_cpu"]
                    and row["stats_equal_cpu"]):
                raise AssertionError(f"fidelity linear {(m, k, n)} x "
                                     f"{scale}: {row}, {same}")
            if scale == 1.0 and sum(row["saturated"]):
                raise AssertionError(f"fidelity linear {(m, k, n)}: "
                                     "saturation on its calibration batch")
            if scale != 1.0 and not sum(row["saturated"]):
                raise AssertionError(f"fidelity linear {(m, k, n)}: no "
                                     f"saturation at adc_fs x {scale}")
            rows.append(row)
    for x in xs + [xs[-1].float() * torch.exp2(torch.randint(
            -60, 60, xs[-1].shape, generator=gen, device=dev).float())]:
        h = _to_host(mxlib.quant_health(x, EXP_BUCKETS))
        h_cpu = _to_host(mxlib.quant_health(x.to(cpu), EXP_BUCKETS))
        equal = all(np.array_equal(h[key], h_cpu[key]) for key in h)
        print("fidelity quant_health", json.dumps(
            {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
             "equal_cpu": equal, "clipped": int(h["clipped"]),
             "underflow": int(h["underflow"]), "total": h["total"],
             "exp_min": int(h["exp_min"]), "exp_max": int(h["exp_max"])}),
            flush=True)
        if not equal:
            raise AssertionError(f"quant_health on the card differs from "
                                 f"the CPU at {tuple(x.shape)}")
    return rows


def _fidelity_digest(rep: dict) -> dict:
    """A fidelity report's figures: output SQNR, the smallest per-layer
    SQNR and its layer, drift, the largest clip and saturation ratios."""
    per = {p: v for p, v in rep["sqnr_db"].items()
           if p != "output" and np.isfinite(v)}
    worst = min(per, key=per.get)
    lay = rep["layers"].values()
    return {"output_sqnr_db": rep["sqnr_db"]["output"],
            "min_layer_sqnr_db": per[worst], "min_layer": worst,
            "n_drifted": rep["drift"]["n_drifted"],
            "max_clip_ratio": max(v.get("clip_ratio", 0.0) for v in lay),
            "max_adc_saturation_ratio": max(
                v.get("adc_saturation_ratio", 0.0) for v in lay)}


def fidelity_model(arch: str, backend: str) -> dict:
    """Phase 10's model level: ``arch`` at full width under ``backend``
    through the launcher's ``--fidelity`` path (``init_lm`` / ``init_vit``,
    ``build_backend``, ``run_fidelity``), probed on its first calibration
    batch. Under ``cim``: every calibrated path covered, ``cim_linear``
    launched once an analog linear and nothing else, no drift; then the
    same pass with ``scale_adc_fs(conv, FID_MISCAL)`` (drift tripped,
    output SQNR at least ``FID_MIN_DROP_DB`` lower) and a lossless CIM
    (no ADC, CM 64, one pass; on the first ``FID_LOSSLESS_LAYERS`` layers
    where given) calibrated and run with ``impl="ref"``, the
    kernel taking CM <= 24 only (output SQNR >= ``FID_LOSSLESS_MIN_DB``).
    Under ``mxfp4``: against float, ``mxfp4_matmul`` launched once a packed
    linear. The probe's cost: the pass's wall against one plain eager
    forward. A ``fidelity`` line a run."""
    import logging

    from repro_torch import obs as obs_lib
    from repro_torch.core import cim as cimlib
    from repro_torch.launch import serve
    from repro_torch.layers.common import RunCtx
    from repro_torch.models import calibrate, lm, vit

    args = serve.build_parser().parse_args(
        ["--arch", arch, "--backend", backend] + FID_COMMON + FID_ARGS[arch])
    obs = obs_lib.Obs()
    t0 = time.perf_counter()
    if arch == "vit-b16":
        cfg, fparams, dev, batches = serve.init_vit(args)
        batch, fwd = batches[0], vit.forward
    else:
        cfg, fparams, dev = serve.init_lm(args)
        batches = calibrate.calibration_batches(
            cfg, n_batches=args.calib_batches, batch=args.batch,
            seq=args.prompt_len, device=dev)
        batch, fwd = serve.fidelity_batch(args, cfg, dev), lm.forward
        if not torch.equal(batch["ids"], batches[0]["ids"]):
            raise AssertionError("the fidelity batch is not the first "
                                 "calibration batch")
    with torch.no_grad():
        params, ctx = serve.build_backend(args, cfg, fparams, dev, obs=obs,
                                          batches=batches, forward_fn=fwd)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    own = VISION_KERNEL[backend]
    linears = _converted_paths(params, "e_n" if backend == "cim" else "codes")
    _zero_counts()
    rep = serve.run_fidelity(args, cfg, fparams, params, ctx, obs, batch,
                             forward_fn=fwd)
    launches, _ = _read_counts()
    routes = _cim_routes() if backend == "cim" else _read_counts()[1]
    want = {k: (len(linears) if k == own else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"fidelity {arch} [{backend}]: launches "
                             f"{launches}, want {want}")
    missing = [p for p in linears if p not in rep["sqnr_db"]
               or (backend == "cim"
                   and "adc_saturation_ratio" not in rep["layers"][p])]
    if missing:
        raise AssertionError(f"fidelity {arch} [{backend}]: paths not "
                             f"covered: {missing[:8]}")
    with torch.no_grad():  # the probe's cost: one plain eager forward
        fwd(params, cfg, ctx, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd(params, cfg, ctx, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
    line = {"model": arch, "backend": backend, "layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "batch_shape": list(batch[next(iter(batch))].shape),
            "reference": "mxfp4_digital" if backend == "cim" else "none",
            "linears_covered": len(linears), "launches": launches,
            "routes": routes, "build_s": build_s, "pass_s": rep["wall_s"],
            "plain_forward_s": plain_s,
            "probe_cost_x": rep["wall_s"] / plain_s} | _fidelity_digest(rep)
    ok = np.isfinite(line["output_sqnr_db"])
    if backend == "cim":
        ok = ok and line["n_drifted"] == 0
        quiet = logging.getLogger("repro_torch.fidelity")
        quiet.disabled = True  # one drift warning a layer otherwise
        try:
            t1 = time.perf_counter()
            _, bad = obs_lib.run_fidelity_pass(
                fparams, obs_lib.scale_adc_fs(params, FID_MISCAL), cfg, ctx,
                batch, obs=obs_lib.Obs(), forward_fn=fwd,
                min_n=args.cim_min_n)
            bad_s = time.perf_counter() - t1
        finally:
            quiet.disabled = False
        ll_cfg = cimlib.CIMConfig(adc_bits=None, cm_bits=64, two_pass=False)
        ll_layers = FID_LOSSLESS_LAYERS.get(arch, cfg.n_layers)
        ll_model, ll_fparams = cfg, fparams
        if ll_layers < cfg.n_layers:  # one segment: its first layers
            ll_model = dataclasses.replace(cfg, n_layers=ll_layers)
            ll_fparams = dict(fparams, segments=[
                fparams["segments"][0][:ll_layers]])
        t1 = time.perf_counter()
        with torch.no_grad():
            conv_ll, _ = calibrate.convert_model_cim(
                ll_fparams, ll_model, RunCtx(dense_attn_max=256), batches,
                cim_cfg=ll_cfg, min_n=args.cim_min_n, forward_fn=fwd)
        ll_ctx = RunCtx(quant="cim", cim=ll_cfg, impl="ref",
                        dense_attn_max=256)
        _zero_counts()
        _, ll = obs_lib.run_fidelity_pass(
            ll_fparams, conv_ll, ll_model, ll_ctx, batch, obs=obs_lib.Obs(),
            forward_fn=fwd, min_n=args.cim_min_n)
        ll_launches = _read_counts()[0]
        ll_s = time.perf_counter() - t1
        del conv_ll
        line |= {
            "miscal": {"adc_fs_scale": FID_MISCAL, "pass_s": bad_s}
            | _fidelity_digest(bad) | {"drifted": bad["drift"]["drifted"][:4]},
            "lossless": {"impl": "ref", "cim": "adc_bits=None cm_bits=64 "
                         "two_pass=False", "layers": ll_layers,
                         "launches": ll_launches,
                         "calibrate_and_pass_s": ll_s}
            | _fidelity_digest(ll)}
        ok = (ok and bad["drift"]["n_drifted"] > 0
              and bad["sqnr_db"]["output"]
              <= line["output_sqnr_db"] - FID_MIN_DROP_DB
              and not any(ll_launches.values())
              and ll["sqnr_db"]["output"] >= FID_LOSSLESS_MIN_DB)
    line["ok"] = bool(ok)
    print("fidelity", json.dumps(line), flush=True)
    if not ok:
        raise AssertionError(f"fidelity {arch} [{backend}] failed its "
                             "checks")
    return {"launches": launches, "line": line}


# --------------------------------------------------------------- phase 12

def _rec_linears(cfg, seg) -> list:
    """A layer's static linears in call order as (K, N, x dtype at
    prefill, x dtype at decode, calibrated): the reference's recurrent
    blocks name none of theirs (no calibration, so under ``cim`` they run
    on the digital MXFP4 W+A path, torch ops); mLSTM's ``wq`` / ``wk`` /
    ``w_if`` take the conv output, f32 at a decode step (``wv`` is never
    applied); the shared block and attention layers are calibrated."""
    from repro_torch.layers import ffn

    bf, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    if seg.kind == "mamba":
        m = seg.mamba
        return [(d, 2 * m.d_inner + 2 * m.n_groups * m.d_state + m.n_heads,
                 bf, bf, False), (m.d_inner, d, bf, bf, False)]
    if seg.kind == "mlstm":
        di, h = seg.xl.d_inner, seg.xl.n_heads
        return [(d, 2 * di, bf, bf, False), (di, di, bf, f32, False),
                (di, di, bf, f32, False), (di, 2 * h, bf, f32, False),
                (di, d, bf, bf, False)]
    if seg.kind == "slstm":
        dff = int(d * seg.xl.ffn_factor)
        return [(d, 4 * d, bf, bf, False), (d, 2 * dff, bf, bf, False),
                (dff, d, bf, bf, False)]
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    glu = cfg.ffn_kind in ffn.GLU_KINDS
    attn = ([(d, hq)] + [(d, hkv)] * 2 + [(hq, d)]
            + [(d, cfg.d_ff)] * (1 + glu) + [(cfg.d_ff, d)])
    if seg.kind == "zshared":
        attn = [(2 * d, d)] + attn + [(d, d)]
    return [(k, n, bf, bf, True) for k, n in attn]


def _recurrent_launches(cfg, backend: str, batch: int, prompt_len: int,
                        decodes: int, min_n: int, attn_max: int,
                        greedy: bool = True, emb: bool = False):
    """Launches by kernel, the matmul kernels' launches by route and
    ``flash_attention``'s by route of one [batch, prompt_len] prefill (the
    layers' linears at batch * prompt_len rows; the head at the last row
    of each lane under ``greedy``, else at every row) and ``decodes``
    [batch, 1] decode steps: a linear is ``mxfp4_matmul``'s under
    ``mxfp4`` where the conversion packs it (K % 32 == 0, N >= ``min_n``),
    ``cim_linear``'s under ``cim`` where it is calibrated (a named
    linear; the recurrent blocks' are not); an audio model's
    ``front_proj`` takes the f32 frame embeddings (``emb``); one causal
    ``flash_attention`` a shared-block visit a prefill past ``attn_max``
    under ``mxfp4`` (under ``cim`` the digital SDPA is torch ops). No
    paged decode: the greedy decode runs on the legacy cache."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.models import lm

    bf = torch.bfloat16
    rows = batch * prompt_len
    body = []
    for seg in lm.build_segments(cfg):
        body += _rec_linears(cfg, seg) * seg.n
    head = ([] if cfg.tie_embeddings
            else [(cfg.d_model, cfg.vocab_size, bf, bf, True)])
    front = ([(cfg.frontend_dim, cfg.d_model, torch.float32, None, True)]
             if emb else [])
    kern = VISION_KERNEL[backend]
    routes: dict = {"cim_linear": {}, "mxfp4_matmul": {}}
    calls = [(rows, 1, front + body, 2), (batch if greedy else rows, 1, head,
                                          2),
             (batch, decodes, body + head, 3)]
    for m, times, shapes, at in calls:
        for lin in shapes:
            k, n, dtype, calibrated = lin[0], lin[1], lin[at], lin[4]
            if not times or k % 32 or n < min_n or (
                    backend == "cim" and not calibrated):
                continue
            r = (cim_ops.pick_route(m, k, n) if backend == "cim"
                 else mm_ops.pick_route(m, k, n, dtype))
            routes[kern][r] = routes[kern].get(r, 0) + times
    launches = dict.fromkeys(_kernel_wrappers(), 0)
    for name, by_route in routes.items():
        launches[name] = sum(by_route.values())
    fa_routes = dict.fromkeys(fa_ops.ROUTES, 0)
    visits = sum(s.kind == "zshared" for s in lm.build_segments(cfg))
    if backend != "cim" and cfg.causal and prompt_len > attn_max and visits:
        launches["flash_attention"] = visits
        fa_routes[fa_ops.pick_route(prompt_len, prompt_len, cfg.hd,
                                    torch.bfloat16)] = visits
    return launches, routes, fa_routes


def check_recurrent_kernels(dev) -> dict:
    """Phase 12's kernel rows, each against its plain version as in phase
    3 (``REC_SHAPES``): ``mxfp4_matmul`` at every packed linear of the
    three archs at a decode step's rows (4; xlstm-125m's ``wq`` also with
    the f32 x a decode gives it) and at the prefill's (2048: 4 lanes of
    512; hubert's 1500 frames, its ``front_proj`` on f32 frame
    embeddings), ``cim_linear`` at the calibrated ones (zamba2-1.2b's
    shared block and head, hubert-xlarge's linears), ``flash_attention``
    at zamba's shared attention over the two prefills that launch it
    ([4, 512] and [1, 2560]; H 32, D 64, causal, bf16). Rows by kernel
    name; each names its arch (``case``) and linear."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.layers import backends

    rows: dict = {"mxfp4_matmul": [], "cim_linear": [],
                  "flash_attention": []}
    gen = torch.Generator(device=dev).manual_seed(12)
    ccfg = cimlib.CIMConfig()
    for arch, linears in REC_SHAPES.items():
        for name, k, n, ms, analog in linears:
            extra = {"case": arch, "linear": name}
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            packed = backends._quantize_packed(w)
            w_bf16 = backends._dequant_packed(packed["codes"],
                                              packed["exps"])
            wq = mxlib.quantize_w(w) if analog else None
            del w
            for m, dtype in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                rows["mxfp4_matmul"].append(_mxfp4_row(
                    x, packed["codes"], packed["exps"], w_bf16, extra))
                if analog:  # the same values, as the wrapper takes them
                    xf = x.float()
                    rows["cim_linear"].append(_cim_row(
                        xf, wq, cimlib.calibrate_rowhist([xf], wq, ccfg),
                        ccfg, extra))
            del packed, w_bf16, wq
    for b, s in ((REC_BATCH, REC_PROMPT), (1, REC_LONG_PROMPT)):
        q, k, v = (torch.randn((b, s, 32, 64), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        rows["flash_attention"].append(
            {"case": "zamba2-1.2b"} | _flash_attention_row(q, k, v, 0, 0))
        print("flash_attention", json.dumps(rows["flash_attention"][-1]),
              flush=True)
        if not rows["flash_attention"][-1]["ok"]:
            raise AssertionError(f"flash_attention kernel disagrees at "
                                 f"{rows['flash_attention'][-1]}")
    return rows


def check_tiny_recurrent(dev, arch: str, backend: str) -> dict:
    """Tiny ``arch`` with the same weights on the card (kernels) and on the
    CPU (plain versions): a prefill into ``init_cache`` (legacy cache,
    states), its last position's logits, then teacher-forced decode steps;
    logits SQNR >= 30 dB at every step."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(
        ["--arch", arch, "--backend", backend, "--device", "cpu",
         "--calib-batches", "1", "--batch", "2", "--log-level", "warning"])
    cfg, cpu_params, ctx, cpu = serve.build_model(args)
    ids = torch.randint(0, cfg.vocab_size, (2, 20),
                        generator=torch.Generator().manual_seed(4))
    runs = []
    with torch.no_grad():
        for params, d in ((cpu_params, cpu), (_to(cpu_params, dev), dev)):
            caches = lm.init_cache(cfg, 2, 24, device=d)
            lo, caches = lm.forward(params, cfg, ctx, {"ids": ids[:, :16].to(
                d)}, caches=caches)
            steps = [lo[:, -1]]
            for p in range(16, 20):
                lo, caches = lm.decode_step(params, cfg, ctx,
                                            ids[:, p:p + 1].to(d), p, caches)
                steps.append(lo)
            runs.append([t.float().cpu() for t in steps])
    sq = [_sqnr_db(a, b) for a, b in zip(*runs)]
    print(f"tiny {arch} [{backend}], card vs CPU plain versions, logits "
          f"SQNR per step (prefill, 4 decode): {sq}", flush=True)
    if min(sq) < 30.0:
        raise AssertionError(f"tiny {arch} [{backend}]: card and CPU logits "
                             "disagree")
    return {"tiny_sqnr_db": sq}


@contextlib.contextmanager
def _packed_on_c(f32_sums: bool = False):
    """``impl="ref"`` with every packed linear on kernel C, as the kernel
    run has it (or, with ``f32_sums``, on the reference's composition
    with its sums in f32: ``_dequant_packed`` and an f32 matmul of the
    bf16-rounded x, rounded to bf16 once: another valid rounding of the
    reference's ``jnp.matmul``, which gives the reference's own spread)."""
    from repro_torch.layers import backends

    be = backends.get_backend("mxfp4_wonly")
    forward = be.forward

    def patched(ctx, params, x):
        if "codes" not in params or ctx.impl != "ref":
            return forward(ctx, params, x)
        if not f32_sums:
            return forward(dataclasses.replace(ctx, impl="auto"), params, x)
        w = backends._dequant_packed(params["codes"], params["exps"])
        return torch.matmul(x.to(torch.bfloat16).float(), w.float()).to(
            torch.bfloat16)

    be.forward = patched  # the instance's attribute shadows the method
    try:
        yield
    finally:
        del be.forward


def recurrent_block_check(cfg, params, kctx, rctx, batch: int,
                          prompt_len: int) -> dict:
    """The first layer of each segment kind of ``cfg`` (a Mamba layer and
    a shared-block visit; an mLSTM and an sLSTM layer) alone, on injected
    bf16 inputs: a ``prompt_len``-row prefill into empty caches and one
    decode step, through the kernels and through ``impl="ref"`` (the
    reference's compositions: the bf16 matmul of the dequantized weight,
    the torch-op ``_flash_attn``); each output's residual delta at SQNR >=
    30 dB. Returns ``{kind: [prefill dB, decode dB]}``."""
    from repro_torch.models import lm

    dev = params["final_ln"]["gamma"].device
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn((batch, prompt_len + 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    x0 = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(prompt_len + 1, device=dev)[None].expand(batch, -1)
    out, seen = {}, set()
    for i, seg in enumerate(lm.build_segments(cfg)):
        if seg.kind in seen:
            continue
        seen.add(seg.kind)
        layer = params["segments"][i][:1]
        res = []
        for ctx in (kctx, rctx):
            cache = [lm.init_cache(cfg, batch, prompt_len + 1,
                                   device=dev)[i][0]]
            kw = dict(path=f"segments/{i}", shared=params.get("shared"))
            with torch.no_grad():  # arange positions: E takes the prefill
                y, cache = lm.run_segment(
                    dataclasses.replace(ctx, arange_positions=True), cfg, seg,
                    layer, x[:, :prompt_len],
                    pos[:, :prompt_len], cache, x0=x0[:, :prompt_len],
                    **kw)
                y1, _ = lm.run_segment(
                    ctx, cfg, seg, layer, x[:, prompt_len:],
                    pos[:, prompt_len:], cache,
                    torch.tensor(prompt_len, device=dev),
                    x0=x0[:, prompt_len:], **kw)
            res.append(((y - x[:, :prompt_len]).float(),
                        (y1 - x[:, prompt_len:]).float()))
        out[seg.kind] = [_sqnr_db(r, g) for r, g in zip(res[1], res[0])]
    print(f"[{kctx.quant} {cfg.name}] recurrent block, kernels vs impl=ref "
          f"(prefill, decode) dB:", json.dumps(out), flush=True)
    if min(min(v) for v in out.values()) < 30.0:
        raise AssertionError(f"[{kctx.quant} {cfg.name}] a block disagrees "
                             f"with impl=ref: {out}")
    return out


def _rec_logits(cfg, params, ctx, prompt, ids, steps: int) -> list:
    """Logits of the greedy decode's prefill (its last position) and of
    ``steps`` decode steps teacher-forced on the served ``ids``, eagerly
    on fresh caches."""
    from repro_torch.models import lm

    b, s = prompt.shape
    caches = lm.init_cache(cfg, b, s + steps + 1, device=prompt.device)
    with torch.no_grad():
        hidden, caches = lm.forward(params, cfg, ctx, {"ids": prompt},
                                    caches=caches, return_hidden=True)
        out = [lm._head(ctx, cfg, params, hidden[:, -1:])[:, -1].float()]
        del hidden
        for t in range(steps):
            lo, caches = lm.decode_step(params, cfg, ctx,
                                        ids[:, t:t + 1].to(prompt.device),
                                        s + t, caches)
            out.append(lo.float())
    return out


def profile_greedy(cfg, params, ctx, batch: int, prompt_len: int,
                   steps: int = 8) -> dict:
    """One prefill under ``torch.profiler`` (eager: the greedy path
    captures only its decode step), then ``steps`` decode steps profiled
    eager (``cuda_graphs=False``) and captured (the first step, outside the
    window, captures both graphs), each also timed unprofiled
    (:func:`_unprofiled`); the windows' ids bitwise equal, their launches
    a step equal. Returns ``{"prefill": profile, "eager": ...,
    "captured": ... + capture_s and graph_pool_bytes}``."""
    from repro_torch.launch import serve

    dev = params["final_ln"]["gamma"].device
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               17))
    kctx = dataclasses.replace(ctx, obs=None)
    out, ids = {}, {}
    for mode in ("eager", "captured"):
        dec = serve.GreedyDecoder(params, cfg, kctx, batch,
                                  prompt_len + 2 * steps + 4, dev,
                                  cuda_graphs=mode == "captured")
        if mode == "eager":
            out["prefill"] = _profiled("recurrent prefill profile", kctx, 1,
                                       lambda: dec.prefill(prompt),
                                       attempts=1)
        dec.prefill(prompt)
        dec.step()  # outside the window (the capture)
        got = []

        def step():
            got.append(dec.step().clone())

        prof = _profiled(f"recurrent decode profile {mode}", kctx, steps,
                         step, attempts=1)
        # each step ends in a host read of its ids, as a served one does
        _unprofiled(prof, steps, lambda: dec.step().cpu(), batch)
        prof["launches_a_step"] = {k: v / steps
                                   for k, v in prof["launches"].items()}
        if dec.graphs:
            prof["capture_s"] = dec.capture_s
            prof["graph_pool_bytes"] = dec.pool_bytes
        ids[mode] = torch.stack(got[:steps], 1).cpu()
        out[mode] = prof
        del dec
    if not torch.equal(ids["eager"], ids["captured"]):
        raise AssertionError(f"[{ctx.quant} {cfg.name}] captured decode ids "
                             "are not the eager ones")
    if out["eager"]["launches_a_step"] != out["captured"]["launches_a_step"]:
        raise AssertionError(f"[{ctx.quant} {cfg.name}] launches a step: "
                             f"{out['eager']['launches_a_step']} eager, "
                             f"{out['captured']['launches_a_step']} captured")
    return out


def serve_recurrent(arch: str, backend: str, batch: int = REC_BATCH,
                    prompt_len: int = REC_PROMPT, tokens: int = REC_TOKENS,
                    profile: bool = True, layers: int = 0) -> dict:
    """Phase 12, one run: ``arch`` at full width and depth (``layers``
    cuts the depth, ``REC_LAYERS``) through the launcher's ``build_model`` and greedy decode (``serve_greedy``, its
    decode step captured), ``batch`` prompts of ``prompt_len`` tokens and
    ``tokens`` new ones. The launches by kernel and route must be exactly
    ``_recurrent_launches``'s. Then: the prefill's last-position logits and
    ``REC_STEPS`` decode steps against ``impl="ref"`` (SQNR >= 30 dB;
    under ``mxfp4`` the ref run keeps its packed linears on C, its C
    launches counted, and the all-plain figure and the reference's own
    spread are printed beside it), the tiny model's logits on the card
    against the CPU's and, with ``profile``, :func:`recurrent_block_check`
    and :func:`profile_greedy` (whose windows hold captured == eager);
    without it the serve's ids against an eager (``cuda_graphs=False``)
    greedy decode's, bitwise. Prints a ``serve recurrent`` line."""
    from repro_torch import obs as obs_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(
        ["--arch", arch, "--no-tiny", "--backend", backend, "--batch",
         str(batch), "--prompt-len", str(prompt_len), "--tokens",
         str(tokens), "--calib-batches", "1", "--layers", str(layers),
         "--log-level", "warning"])
    obs = obs_lib.Obs()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_model(args, obs=obs)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    resident = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[{backend}] {cfg.name}: full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, segments "
          f"{[(s.kind, s.n) for s in lm.build_segments(cfg)]}); build peak "
          f"{build_peak / 2**30:.2f} GiB, resident {resident / 2**30:.2f} "
          f"GiB", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    served = serve.serve_greedy(args, cfg, params, ctx, obs, dev)
    launches, mm_routes = _read_counts()
    routes = {"cim_linear": _cim_routes(), "mxfp4_matmul": mm_routes}
    routes = {k: {r: n for r, n in v.items() if n} for k, v in routes.items()}
    fa_routes = dict(fa_ops.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    want, want_routes, want_fa = _recurrent_launches(
        cfg, backend, batch, prompt_len, tokens - 1, args.cim_min_n,
        ctx.dense_attn_max)
    exact = (launches == want and routes == want_routes
             and fa_routes == want_fa)
    ids = served["ids"]
    if tuple(ids.shape) != (batch, tokens) or not bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError(f"[{backend} {arch}] served ids {ids.shape}")
    t1 = time.perf_counter()
    kctx = dataclasses.replace(ctx, obs=None)
    rctx = dataclasses.replace(kctx, impl="ref")
    steps = min(REC_STEPS, tokens - 1)
    prompt = served["prompt"]
    got = _rec_logits(cfg, params, kctx, prompt, ids[:, 1:], steps)
    plain = _rec_logits(cfg, params, rctx, prompt, ids[:, 1:], steps)
    sq_plain = [_sqnr_db(r, g) for r, g in zip(plain, got)]
    sq_spread = ref_c = want_ref_c = None
    if backend == "mxfp4":
        # the model turns one bf16 ulp of a linear's output into ~27 dB at
        # the logits (C's f32 sums in another order than cuBLAS's): the
        # impl="ref" run keeps the packed linears on C, which its rows and
        # the block check hold to the composition; the reference's own
        # spread (its composition with f32 sums) is printed beside it
        c0 = mm_ops.mxfp4_matmul.launches
        with _packed_on_c():
            ref = _rec_logits(cfg, params, rctx, prompt, ids[:, 1:], steps)
        ref_c = mm_ops.mxfp4_matmul.launches - c0
        want_ref_c = _recurrent_launches(
            cfg, backend, batch, prompt_len, steps, args.cim_min_n,
            ctx.dense_attn_max)[0]["mxfp4_matmul"]
        with _packed_on_c(f32_sums=True):
            spread = _rec_logits(cfg, params, rctx, prompt, ids[:, 1:], steps)
        sq_spread = [_sqnr_db(r, g) for r, g in zip(plain, spread)]
        del spread
    else:
        ref = plain
    sq = [_sqnr_db(r, g) for r, g in zip(ref, got)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del got, ref, plain
    blocks = (recurrent_block_check(cfg, params, kctx, rctx, batch,
                                    prompt_len) if profile else None)
    check_s = time.perf_counter() - t1
    if profile:  # the profile's windows hold captured == eager
        prof = profile_greedy(cfg, params, ctx, batch, prompt_len)
        bitwise = True
        eager_tok_s = prof["eager"]["tok_s"]
    else:
        prof = None
        eager = serve.greedy_decode(params, cfg, kctx, prompt, tokens,
                                    cuda_graphs=False)
        bitwise = bool(torch.equal(eager["ids"], ids))
        eager_tok_s = (tokens - 1) * batch / eager["decode_s"]
    tiny = check_tiny_recurrent(dev, arch, backend)
    gaps = served["token_s"]
    line = {"model": cfg.name, "backend": backend, "layers": cfg.n_layers,
            "batch": batch, "prompt_len": prompt_len, "tokens": tokens,
            "tok_s": served["tok_s"], "eager_tok_s": eager_tok_s,
            "token_ms_p50": float(np.median(gaps)) * 1e3,
            "prefill_s": served["prefill_s"],
            "capture_s": served["capture_s"],
            "graph_pool_mib": (served["pool_bytes"] or 0) / 2**20,
            "state_bytes_a_lane": served["state_bytes"],
            "state_mib_a_lane": served["state_bytes"] / 2**20,
            "launches": launches, "routes": routes,
            "flash_attention_routes": fa_routes, "want_launches": want,
            "want_routes": want_routes, "launches_exact": exact,
            "logits_sqnr_db": sq, "logits_ref": (
                "impl=ref, packed linears on C" if backend == "mxfp4"
                else "impl=ref"),
            "logits_sqnr_vs_plain_ref_db": sq_plain,
            "reference_spread_db": sq_spread, "ref_c_launches": ref_c,
            "want_ref_c_launches": want_ref_c, "block_sqnr_db": blocks,
            "finite": finite, "captured_equals_eager": bitwise, **tiny,
            "logits_check_s": check_s, "peak_mem_gib": peak / 2**30,
            "build_peak_mem_gib": build_peak / 2**30,
            "resident_params_gib": resident / 2**30, "model_build_s": build_s}
    if prof is not None:
        line |= {"prefill_device_ms": prof["prefill"]["device_ms_per_step"],
                 "prefill_kernel_ms": prof["prefill"]["kernel_ms_per_step"],
                 "prefill_wall_ms": prof["prefill"]["wall_ms_per_step"],
                 "decode_kernel_ms": prof["captured"]["kernel_ms_per_step"],
                 "decode_route_ms": prof["captured"]["route_ms_per_step"],
                 "decode": _step_pair(prof)}
    print("serve recurrent", json.dumps(line), flush=True)
    if not exact:
        raise AssertionError(f"[{backend} {arch}] launches {launches} routes "
                             f"{routes} flash {fa_routes}; want {want} "
                             f"{want_routes} {want_fa}")
    if not finite or min(sq) < 30.0:
        raise AssertionError(f"[{backend} {arch}] logits disagree: {sq}")
    if ref_c != want_ref_c:
        raise AssertionError(f"[{backend} {arch}] the impl=ref run launched "
                             f"C {ref_c} times, not {want_ref_c}")
    if not bitwise:
        raise AssertionError(f"[{backend} {arch}] captured greedy ids are "
                             "not the eager ones")
    return {"launches": launches, "line": line}


def encode_audio(backend: str) -> dict:
    """Phase 12, hubert-xlarge (48 layers, full width; ``REC_LAYERS`` cuts
    its depth under ``cim``) under ``backend``
    through the launcher's ``build_model`` (``cim``: calibrated on one
    ``emb`` batch) and ``lm.forward`` on one ``emb`` batch [1, 1500, 512]
    (30 s of audio at 50 frames a second): launches exactly
    ``_recurrent_launches``'s (one a linear a layer, ``front_proj`` and the
    head; no attention kernel: non-causal), logits against ``impl="ref"``
    (SQNR >= 30 dB), device ms and wall of the forward. Prints an ``encode
    audio`` line."""
    from repro_torch import obs as obs_lib
    from repro_torch import resolve_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    layers = REC_LAYERS.get(("hubert-xlarge", backend), 0)
    args = serve.build_parser().parse_args(
        ["--arch", "hubert-xlarge", "--no-tiny", "--backend", backend,
         "--batch", "1", "--calib-batches", "1", "--layers", str(layers),
         "--log-level", "warning"])
    dev = resolve_device(args.device)
    fdim = serve.lm_config(args).frontend_dim
    gen = torch.Generator(device=dev).manual_seed(32)
    emb, calib = (torch.randn((1, AUDIO_FRAMES, fdim), generator=gen,
                              device=dev) for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_model(
        args, obs=obs_lib.Obs(), batches=[{"emb": calib}])
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    kctx = dataclasses.replace(ctx, obs=None)
    rctx = dataclasses.replace(kctx, impl="ref")

    def forward(c=kctx):
        return lm.forward(params, cfg, c, {"emb": emb})[0]

    with torch.no_grad():
        _zero_counts()
        got = forward()
        torch.cuda.synchronize()
        launches, mm_routes = _read_counts()
        routes = {"cim_linear": _cim_routes(), "mxfp4_matmul": mm_routes}
        routes = {k: {r: n for r, n in v.items() if n}
                  for k, v in routes.items()}
        fa_routes = dict(fa_ops.flash_attention.route_launches)
        want, want_routes, want_fa = _recurrent_launches(
            cfg, backend, 1, AUDIO_FRAMES, 0, args.cim_min_n,
            ctx.dense_attn_max, greedy=False, emb=True)
        exact = (launches == want and routes == want_routes
                 and fa_routes == want_fa)
        ref = forward(rctx)
        sq = _sqnr_db(ref.float(), got.float())
        finite = bool(torch.isfinite(got.float()).all())
        del ref
        device_ms = _device_ms(forward, 2)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
    wall_ms = float(np.median(walls)) * 1e3
    line = {"model": cfg.name, "backend": backend, "layers": cfg.n_layers,
            "emb": list(emb.shape), "logits": list(got.shape),
            "launches": launches, "routes": routes,
            "flash_attention_routes": fa_routes, "want_launches": want,
            "want_routes": want_routes, "launches_exact": exact,
            "logits_sqnr_db": sq, "finite": finite, "device_ms": device_ms,
            "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
            "frames_s": AUDIO_FRAMES / wall_ms * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "build_peak_mem_gib": build_peak / 2**30, "model_build_s": build_s}
    print("encode audio", json.dumps(line), flush=True)
    if not exact:
        raise AssertionError(f"[{backend} hubert] launches {launches} routes "
                             f"{routes} flash {fa_routes}; want {want} "
                             f"{want_routes} {want_fa}")
    if not finite or sq < 30.0:
        raise AssertionError(f"[{backend} hubert] logits disagree: {sq}")
    return {"launches": launches, "line": line}


def recurrent_kernel_entries(rec_rows: dict, runs: dict) -> list:
    """The kernels line's entries of phase 12: ``mxfp4_matmul`` and
    ``cim_linear`` at the three archs' linears and ``flash_attention`` at
    zamba's shared attention, each with its launches in the run that ran
    it (the arch's ``mxfp4`` or ``cim`` run; for E, the long zamba
    prefill)."""
    out = []
    for name, replaces, run in (
            ("mxfp4_matmul", "src/repro/kernels/mxfp4_matmul/kernel.py:69",
             "mxfp4"),
            ("cim_linear", "src/repro/kernels/cim_linear/kernel.py:127",
             "cim"),
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:90", "long")):
        for row in rec_rows[name]:
            if name == "flash_attention":
                shape = (f"B={row['b']} S={row['sq']} H={row['h']} "
                         f"Hkv={row['hkv']} D={row['d']} bf16 causal")
                key = ("rec zamba2-1.2b long" if row["sq"] == REC_LONG_PROMPT
                       else "rec zamba2-1.2b mxfp4")
            else:
                shape = (f"M={row['m']} K={row['k']} N={row['n']} "
                         f"{row['x_dtype']} ({row['linear']})")
                key = f"rec {row['case']} {run}"
            out.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": runs[key]["launches"][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"),
                "call_ms": row["call_ms"], "kernel_route": row.get("route"),
                "shape": f"{shape} ({row['case']})"})
    return out


# --------------------------------------------------------------- phase 13

def _vit_pipe_routes(cfg, backend: str, runner, forwards: int,
                     stage_runs: int) -> dict:
    """Launches by route of ``forwards`` pipelined forwards of the
    runner's capacity (the patch embedding over every frame, each
    microbatch's trunk at mb * seq rows, the classifier over the CLS
    rows) and ``stage_runs`` runs of every stage alone on one microbatch
    (``measure_stage_walls``, which first embeds the capacity's frames
    once)."""
    cap, rows = runner.capacity, runner.mb_size * cfg.seq_len
    embed = [(cap * cfg.n_patches, cfg.patch_dim, cfg.d_model,
              torch.float32)]
    fwd = (embed + runner.n_replicas * runner.microbatches
           * _vit_trunk_shapes(cfg, rows)
           + [(cap, cfg.d_model, cfg.n_classes, torch.bfloat16)])
    stages = (embed + _vit_trunk_shapes(cfg, rows) * stage_runs
              if stage_runs else [])
    return _matmul_routes(backend, fwd * forwards + stages)


def _overlap_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (ending in a
    synchronize), the device ms of its events summed (``device_ms``), the
    time at least one ran (``busy_ms``, over the wall: ``busy_share``)
    and the time at least two ran at once (``overlap_ms``: kernels of one
    stream run one after another, so this is time in which two stages'
    kernels ran together)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == DeviceType.CUDA
             and not getattr(ev, "is_user_annotation", False)
             and ev.time_range.end > ev.time_range.start]
    edges = sorted([(a, 1) for a, _ in spans] + [(b, -1) for _, b in spans])
    busy = overlap = 0.0
    depth, last = 0, None
    for t, step in edges:
        if last is not None and depth >= 1:
            busy += t - last
            if depth >= 2:
                overlap += t - last
        depth, last = depth + step, t
    device_ms = sum(b - a for a, b in spans) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_ms": busy / 1e3, "busy_share": busy / 1e3 / wall_ms,
            "overlap_ms": overlap / 1e3, "events": len(spans)}


def _measured_gauges(obs, stages: int) -> None:
    """The ``pipeline_measured_*`` gauges ``serve_vision`` /
    ``serve_pipelined_lm`` published, one stage label a stage."""
    snap = obs.registry.snapshot()
    for fam in ("stage_wall_seconds", "stage_occupancy"):
        labels = {s["labels"]["stage"]
                  for s in snap[f"pipeline_measured_{fam}"]["series"]}
        if labels != {str(i) for i in range(stages)}:
            raise AssertionError(f"pipeline_measured_{fam}: stages {labels}")
    for fam in ("bubble_fraction", "fill_latency_seconds",
                "step_wall_seconds", "throughput_items_per_s",
                "steady_state_fps", "stages", "replicas"):
        if f"pipeline_measured_{fam}" not in snap:
            raise AssertionError(f"pipeline_measured_{fam} not published")


def pipeline_vit() -> dict:
    """Phase 13, ViT-L/32 ``cim`` at full width and depth over two stages
    (12 + 12 layers) on the one card, through the launcher's
    ``serve_vision`` (``PIPE_VIT_ARGS``, ``mesh=``: both grid places on
    the card, each on its own stream): exact launches by route (only
    ``cim_linear``); ``PIPE_FRAMES`` frames through the pipeline bitwise
    the two-chip chain of phase 8 (captured, one frame a call: the same
    kernels on the same rows a launch), the captured step bitwise the
    eager one, 4 frames against ``impl="ref"`` (SQNR >= 30 dB); the
    transfer guard (resident trunk before and after three steps, only the
    activation hop, its bytes exactly (S - 1) M R mb 145 1024 2 and under
    a tenth of the trunk); one step profiled captured and eager (device
    ms, busy share, ``overlap_ms``) and the chain's ``fps_host`` on the
    same frames. Prints a ``serve pipeline`` line."""
    from repro_torch import obs as obs_lib
    from repro_torch.distributed import pipeline_exec as pex
    from repro_torch.launch import serve
    from repro_torch.models import vit
    from repro_torch.serving import VisionEngine

    args = serve.build_parser().parse_args(PIPE_VIT_ARGS)
    obs = obs_lib.Obs()
    t0 = time.perf_counter()
    cfg, params, ctx, dev = serve.build_vision_model(args, obs=obs)
    build_s = time.perf_counter() - t0
    mesh = pex.make_pipeline_mesh(2, devices=[dev] * 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    summary = serve.serve_vision(args, cfg, params, ctx, obs, dev, mesh=mesh)
    launches, _ = _read_counts()
    routes = {r: n for r, n in _cim_routes().items() if n}
    runner = summary["runner"]
    # serve_vision: one forward of its frames, then measure(reps=2): a warm
    # forward, two timed, and each stage alone twice (captured: two
    # replays; eager: a warm run and two)
    want = _vit_pipe_routes(cfg, "cim", runner, forwards=4,
                            stage_runs=2 if runner.graphs else 3)
    if (runner.bounds != [(0, 12), (12, 24)] or runner.mb_size != 1
            or launches["cim_linear"] != sum(want.values())
            or any(v for k, v in launches.items() if k != "cim_linear")
            or routes != want):
        raise AssertionError(f"[pipeline vit-l32] cuts {runner.bounds}, "
                             f"launches {launches} routes {routes}; want "
                             f"cim_linear only on {want}")
    _measured_gauges(obs, 2)
    kctx = dataclasses.replace(ctx, obs=None)
    gen = torch.Generator(device=dev).manual_seed(31)
    frames = torch.randn((PIPE_FRAMES, cfg.image_size, cfg.image_size,
                          cfg.in_channels), generator=gen, device=dev)
    cap = runner.capacity
    steps = [{"images": frames[i:i + cap]} for i in range(0, PIPE_FRAMES,
                                                           cap)]
    resident_before = runner.trunk_resident()
    _zero_counts()
    with torch.no_grad():
        piped = torch.cat([runner.forward(b) for b in steps])
        step_launches, _ = _read_counts()
        step_routes = {r: n for r, n in _cim_routes().items() if n}
        runner.forward(steps[0])  # the third step
    want_steps = _vit_pipe_routes(cfg, "cim", runner, len(steps), 0)
    resident_after = runner.trunk_resident()
    # phase 8's two-chip chain on the same frames, captured, one a call
    chain = VisionEngine(params, cfg, kctx)
    chain_logits = torch.cat([chain.logits(f[None]) for f in frames])
    chain_bitwise = bool(torch.equal(piped, chain_logits))
    chain.stream(frames[:1])  # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chain.stream(frames)  # each frame ends in a host read
    chain_fps = PIPE_FRAMES / (time.perf_counter() - t1)
    eager_runner = pex.build_vit_pipeline(
        params, cfg, kctx, stages=2, microbatches=runner.microbatches,
        mb_size=runner.mb_size, mesh=mesh, cuda_graphs=False)
    with torch.no_grad():
        eager = torch.cat([eager_runner.forward(b) for b in steps])
        ref_ctx = dataclasses.replace(kctx, impl="ref")
        ref = torch.cat([vit.forward(params, cfg, ref_ctx,
                                     {"images": f[None]})[0]
                         for f in frames[:VISION_CHECK_FRAMES]])
    captured_bitwise = bool(torch.equal(piped, eager))
    sq = _sqnr_db(ref.float(), piped[:VISION_CHECK_FRAMES].float())
    finite = bool(torch.isfinite(piped).all())
    stats = runner.collectives(steps[0])
    hop_bytes = ((runner.n_stages - 1) * runner.microbatches
                 * runner.n_replicas * runner.mb_size * cfg.seq_len
                 * cfg.d_model * 2)
    prof = {"captured": _overlap_profile(lambda: runner.forward_raw(
                steps[0])),
            "eager": _overlap_profile(lambda: eager_runner.forward_raw(
                steps[0]))}
    graph = next(iter(runner.graphs.values()))[0] if runner.graphs else None
    peak = torch.cuda.max_memory_allocated()
    m = summary["measured"]
    line = {"model": cfg.name, "backend": args.backend,
            "layers": cfg.n_layers, "stages": runner.n_stages,
            "stage_cuts": runner.bounds, "microbatches": runner.microbatches,
            "mb_size": runner.mb_size, "capacity": cap,
            "fps": m["fps"], "steady_fps": m["steady_fps"],
            "bubble": m["bubble"], "fill_ms": m["fill_ms"],
            "step_wall_ms": m["step_wall_ms"],
            "stage_wall_ms": m["stage_wall_ms"],
            "chain_fps_host": chain_fps, "serve_fps_host":
                summary["fps_host"],
            "step": prof, "overlap_ms": prof["captured"]["overlap_ms"],
            # the profiled window's device-busy time over the unprofiled
            # step wall (the profiler's own cost inflates its window)
            "busy_share_of_step": prof["captured"]["busy_ms"]
            / m["step_wall_ms"] if prof["captured"].get("busy_ms") else None,
            "capture_s": graph.capture_s if graph else None,
            "graph_pool_mib": graph.pool_bytes / 2**20 if graph else None,
            "peak_mem_gib": peak / 2**30, "model_build_s": build_s,
            "launches": launches, "routes": routes,
            "step_launches": step_launches["cim_linear"],
            "step_routes": step_routes, "want_step_routes": want_steps,
            "chain_bitwise": chain_bitwise,
            "captured_equals_eager": captured_bitwise,
            "logits_sqnr_db": sq, "finite": finite,
            "trunk_resident": [resident_before, resident_after],
            "hop_bytes": stats.wire_bytes, "want_hop_bytes": hop_bytes,
            "hops": stats.by_kind, "trunk_mib": runner.trunk_bytes / 2**20}
    print("serve pipeline", json.dumps(line), flush=True)
    if (step_routes != want_steps or any(
            v for k, v in step_launches.items() if k != "cim_linear")):
        raise AssertionError(f"[pipeline vit-l32] {len(steps)} steps "
                             f"launched {step_launches} {step_routes}; want "
                             f"cim_linear on {want_steps}")
    if not (chain_bitwise and captured_bitwise):
        raise AssertionError("[pipeline vit-l32] logits: chain bitwise "
                             f"{chain_bitwise}, captured == eager "
                             f"{captured_bitwise}")
    if not finite or sq < 30.0:
        raise AssertionError(f"[pipeline vit-l32] logits vs impl=ref {sq}")
    if (not (resident_before and resident_after)
            or set(stats.by_kind) != {"collective-permute"}
            or stats.wire_bytes != hop_bytes
            or stats.wire_bytes >= runner.trunk_bytes / 10):
        raise AssertionError(f"[pipeline vit-l32] transfer guard: "
                             f"{stats}, trunk {runner.trunk_bytes}")
    return {"launches": launches, "line": line}


def pipeline_router() -> dict:
    """Phase 13, ViT-B/16 ``mxfp4`` at full width and depth over a 2 x 2
    grid (two replicas of two stages, 6 + 6 layers; all four grid places
    on the one card) through the launcher's ``serve_vision``
    (``PIPE_ROUTER_ARGS``), then a ``ReplicaRouter``: three ragged
    submissions, ``dispatched == [2, 1]``, each ticket's rows bitwise the
    same function computed on one stream with the same rows a launch
    (:func:`_same_rows_vit`: the router's packed slab embedded whole, each
    microbatch's trunk alone, the classifier over the slab), and against
    ``vit.forward`` on the ticket's own rows (SQNR >= 30 dB, the logits
    gate; printed beside ``vit.forward``'s own spread between those rows
    alone and padded to the slab: kernel C splits K by the rows it is
    given, in the patch embedding's ``fma`` route and the classifier's).
    Prints a ``serve pipeline router`` line."""
    from repro_torch import obs as obs_lib
    from repro_torch.distributed import pipeline_exec as pex
    from repro_torch.launch import serve
    from repro_torch.models import vit

    args = serve.build_parser().parse_args(PIPE_ROUTER_ARGS)
    obs = obs_lib.Obs()
    cfg, params, ctx, dev = serve.build_vision_model(args, obs=obs)
    mesh = pex.make_pipeline_mesh(2, 2, devices=[dev] * 4)
    _zero_counts()
    summary = serve.serve_vision(args, cfg, params, ctx, obs, dev, mesh=mesh)
    launches, mm_routes = _read_counts()
    runner = summary["runner"]
    if (runner.bounds != [(0, 6), (6, 12)] or not launches["mxfp4_matmul"]
            or any(v for k, v in launches.items() if k != "mxfp4_matmul")):
        raise AssertionError(f"[pipeline router] cuts {runner.bounds}, "
                             f"launches {launches}")
    _measured_gauges(obs, 2)
    kctx = dataclasses.replace(ctx, obs=None)
    gen = torch.Generator(device=dev).manual_seed(32)
    frames = torch.randn((3, cfg.image_size, cfg.image_size,
                          cfg.in_channels), generator=gen, device=dev)
    router = pex.ReplicaRouter(runner)
    parts = (frames[:2], frames[2:], frames[:1])  # 2, 1 (ragged), 1 rows
    tickets = [router.submit({"images": p}) for p in parts]
    outs = router.flush()
    slot, reps = router.slot_rows, runner.n_replicas
    same_rows, vs_forward, spread = [], [], []
    with torch.no_grad():
        for g0 in range(0, len(parts), reps):  # the router's slabs
            slabs = [pex._pad_rows({"images": p}, slot)["images"]
                     for p in parts[g0:g0 + reps]]
            slabs += slabs[:1] * (reps - len(slabs))
            want = _same_rows_vit(params, cfg, kctx, runner,
                                  torch.cat(slabs))
            for si, p in enumerate(parts[g0:g0 + reps]):
                got = outs[tickets[g0 + si]]
                n = p.shape[0]
                same_rows.append(bool(torch.equal(
                    got, want[si * slot:si * slot + n])))
                ref, _ = vit.forward(params, cfg, kctx, {"images": p})
                vs_forward.append(_sqnr_db(ref.float(), got.float()))
                padded, _ = vit.forward(params, cfg, kctx, pex._pad_rows(
                    {"images": p}, runner.capacity))
                spread.append(_sqnr_db(ref.float(), padded[:n].float()))
    line = {"model": cfg.name, "backend": args.backend, "grid": "2x2",
            "stage_cuts": runner.bounds, "capacity": runner.capacity,
            "slot_rows": router.slot_rows, "dispatched": router.dispatched,
            "tickets_same_rows_bitwise": same_rows,
            "tickets_vs_forward_sqnr_db": vs_forward,
            "forward_own_spread_db": spread, "launches": launches,
            "mxfp4_matmul_routes": mm_routes,
            "measured": summary["measured"],
            "fps_host": summary["fps_host"]}
    print("serve pipeline router", json.dumps(line), flush=True)
    if (router.dispatched != [2, 1] or not all(same_rows)
            or min(vs_forward) < 30.0):
        raise AssertionError(f"[pipeline router] dispatched "
                             f"{router.dispatched}, same rows bitwise "
                             f"{same_rows}, vs forward {vs_forward} dB")
    return {"launches": launches, "line": line}


def _same_rows_vit(params, cfg, ctx, runner, images: torch.Tensor):
    """The pipelined ViT forward's function on ``images`` (the runner's
    capacity) on the current stream, with the rows a launch the pipeline
    gives: the patch embedding over every frame, each microbatch's whole
    trunk alone, the final norm and classifier over every frame."""
    from repro_torch.models import vit

    x = vit.embed_images(ctx, cfg, params, images)
    mb = runner.mb_size
    y = torch.cat([vit.encode(params["segments"][0], cfg, ctx, x[i:i + mb])
                   for i in range(0, x.shape[0], mb)])
    return vit.head(ctx, cfg, params, y)


def pipeline_lm() -> dict:
    """Phase 13, starcoder2-7b ``cim`` at full width, 8 of 32 layers
    (phase 4's model), over four stages on the one card through the
    launcher's ``serve_pipelined_lm`` (``PIPE_LM_ARGS``: 2 microbatches of
    2 prompts of 192 tokens): only ``cim_linear`` launched, ``parity``
    bitwise or the logits >= 60 dB against the one-device forward (the
    reference's bounds), then once more on balanced cuts from
    ``serve_layer_costs``. Prints a ``serve pipeline lm`` line."""
    from repro_torch import obs as obs_lib
    from repro_torch.distributed import blockwise
    from repro_torch.distributed import pipeline_exec as pex
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(PIPE_LM_ARGS)
    obs = obs_lib.Obs()
    cfg, params, ctx, dev = serve.build_model(args, obs=obs)
    mesh = pex.make_pipeline_mesh(4, devices=[dev] * 4)
    _zero_counts()
    out = serve.serve_pipelined_lm(args, cfg, params, ctx, obs, dev,
                                   mesh=mesh)
    launches, _ = _read_counts()
    routes = {r: n for r, n in _cim_routes().items() if n}
    _measured_gauges(obs, 4)
    runner, ref = out["runner"], out["ref"].float()
    sq = _sqnr_db(ref, out["logits"].float())
    costs = blockwise.serve_layer_costs(cfg, args.prompt_len)
    with torch.no_grad():
        bal, brunner = lm.forward_pipelined(
            params, cfg, dataclasses.replace(ctx, obs=None), out["batch"],
            stages=4, microbatches=args.microbatches,
            mb_size=runner.mb_size, mesh=mesh, mode="balanced",
            seq_len=args.prompt_len)
    bal_parity = ("bitwise" if torch.equal(bal, out["ref"])
                  else _sqnr_db(ref, bal.float()))
    rep = out["report"]
    line = {"model": cfg.name, "backend": args.backend,
            "layers": cfg.n_layers, "stages": runner.n_stages,
            "stage_cuts": runner.bounds, "balanced_cuts": brunner.bounds,
            "layer_costs_equal": len(set(costs)) == 1,
            "microbatches": runner.microbatches, "mb_size": runner.mb_size,
            "prompt_len": args.prompt_len, "parity": out["parity"],
            "logits_sqnr_db": sq, "balanced_parity": bal_parity,
            "step_wall_ms": rep.step_wall_s * 1e3,
            "stage_wall_ms": [w * 1e3 for w in rep.stage_walls_s],
            "rows_s": rep.throughput_items_per_s,
            "steady_rows_s": rep.steady_items_per_s,
            "bubble": rep.bubble_fraction,
            "fill_ms": rep.fill_latency_s * 1e3,
            "one_device_forward_ms": out["base_wall_s"] * 1e3,
            "launches": launches, "routes": routes,
            "hops": runner.collectives(out["batch"]).by_kind,
            "trunk_resident": runner.trunk_resident()}
    print("serve pipeline lm", json.dumps(line), flush=True)
    if not launches["cim_linear"] or any(
            v for k, v in launches.items() if k != "cim_linear"):
        raise AssertionError(f"[pipeline lm] launches {launches}")
    if out["parity"] != "bitwise" and sq < 60.0:
        raise AssertionError(f"[pipeline lm] parity {out['parity']}, {sq} dB")
    if bal_parity != "bitwise" and bal_parity < 60.0:
        raise AssertionError(f"[pipeline lm] balanced cuts {brunner.bounds}:"
                             f" {bal_parity} dB")
    return {"launches": launches, "line": line}


def _tree_sqnr(want, got) -> float:
    """The least SQNR (dB) over the leaves of two trees of one layout."""
    from repro_torch.optim import adamw

    return min(_sqnr_db(w.detach().float().cpu(), g.detach().float().cpu())
               for w, g in zip(adamw.leaves(want), adamw.leaves(got)))


def _train_step_split(cfg, bundle, params, batch, step_device_ms: float
                      ) -> dict:
    """Where a train step's device time goes, each part run alone and its
    kernels summed by the profiler (:func:`_device_ms`; host gaps are not
    in it, so the parts add up however busy the host keeps the card): the
    weights' step-boundary fake-quant (``quantize_weights_tree``, its
    autograd graph built), the forward and backward of ``lm_loss`` under
    the prequant backend and again under ``float_bf16`` on the same
    prequantized weights (their difference: the activations' fake-quant),
    and AdamW; shares of ``step_device_ms`` (the profiled steps' median),
    the rest ``other_ms``; and the whole step's unprofiled wall (CUDA
    events, median of 2). State that a part changes is a copy."""
    from repro_torch.layers.common import RunCtx, quantize_weights_tree
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    nd = lm.ref_ndim_tree(cfg, params)

    def quant():
        with torch.enable_grad():
            return quantize_weights_tree(params, nd)

    qd = adamw.tree_map(quant(), lambda t: t.detach())

    def fwd_bwd(quant_name):
        ctx = RunCtx(quant=quant_name, dense_attn_max=TRAIN_DENSE_MAX)

        def run():
            flat = [t.requires_grad_(True) for t in adamw.leaves(qd)]
            with torch.enable_grad():
                loss = lm.lm_loss(qd, cfg, ctx, batch)
                torch.autograd.grad(loss, flat, allow_unused=True)
        return run

    copy = adamw.tree_map(params, lambda t: t.detach().clone())
    out = {"quant_ms": _device_ms(quant, 1),
           "fwd_bwd_ms": _device_ms(fwd_bwd("mxfp4_ste_prequant"), 1),
           "fwd_bwd_float_ms": _device_ms(fwd_bwd("none"), 1)}
    del qd
    state = adamw.init(copy)
    grads = adamw.tree_map(copy, torch.ones_like)
    out["adamw_ms"] = _device_ms(lambda: adamw.apply(
        adamw.AdamWConfig(), copy, grads, state), 1)
    del grads
    state = adamw.init(copy)
    out["step_wall_ms"] = _time_ms(lambda: bundle.fn(copy, state, batch), 2,
                                   warm=1)
    out["act_quant_ms"] = out["fwd_bwd_ms"] - out["fwd_bwd_float_ms"]
    out["other_ms"] = (step_device_ms - out["quant_ms"] - out["fwd_bwd_ms"]
                       - out["adamw_ms"])
    for k in ("quant", "act_quant", "fwd_bwd", "adamw", "other"):
        out[f"{k}_share"] = out[f"{k}_ms"] / step_device_ms
    return out


def _attn_ffn_grads_nonzero(cfg, m) -> list:
    """Paths of the attention and FFN weights whose first moment (a fresh
    state's: (1 - b1) times the clipped gradient) is all zero."""
    names = (("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("w1", "w2", "w3")))
    dead = []
    for i, seg in enumerate(m["segments"]):
        for j, layer in enumerate(seg):
            for block, keys in names:
                for key in keys:
                    if key in layer[block] and not bool(
                            layer[block][key]["w"].any()):
                        dead.append(f"segments/{i}/{j}/{block}/{key}")
    return dead


def train_full_width(dev, cfg=None, shape=None, steps: int = TRAIN_STEPS
                     ) -> dict:
    """Phase 14a: ``cfg`` (default h2o-danube-1.8b at full width, 12 of 24
    layers) trains through ``launch.steps.make_train_step`` (``mxfp4_ste``,
    hence the prequant backend; one microbatch) in a loop over
    ``data.pipeline.Pipeline``, the loop body of the reference launcher's
    mesh branch. Each step is profiled (device ms, busy share: device ms
    over the step's wall ms under the profiler), with tokens/s and peak
    allocated memory. Checks: losses and grad norms finite, step 1's loss
    within ``TRAIN_LOSS_REL`` of ln(vocab) and bitwise the per-call
    ``mxfp4_ste`` loss of the same params and batch (exact hoisting);
    then one step with k=1 (on a copy) and one with k=2 from the same
    params, each from a fresh AdamW state, whose first moments (the
    clipped gradients) agree at ``TRAIN_K2_MIN_SQNR_DB``; every attention
    and FFN weight has a nonzero gradient; no kernel launched (the
    reference's training runs no Pallas kernel). Then the step's device split
    and unprofiled wall (:func:`_train_step_split`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs as C
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.layers.common import RunCtx
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = cfg or dataclasses.replace(C.ARCHS[TRAIN_ARCH],
                                     n_layers=TRAIN_LAYERS)
    shape = shape or C.Shape(TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens = shape.seq * shape.batch
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in adamw.leaves(params))
    bundle = steps_mod.make_train_step(cfg, shape, quant="mxfp4_ste",
                                       microbatches=1, device=dev,
                                       dense_attn_max=TRAIN_DENSE_MAX)
    opt_state = adamw.init(params)
    pipe = Pipeline(cfg, shape, seed=0, device=dev)
    rows = []
    _zero_counts()
    try:
        step0, batch = pipe.get()
        for t in adamw.leaves(params):
            t.requires_grad_(True)
        with torch.enable_grad():  # grad on: the path the step runs
            per_call = lm.lm_loss(params, cfg, RunCtx(
                quant="mxfp4_ste", dense_attn_max=TRAIN_DENSE_MAX),
                batch).detach()
        for i in range(steps):
            if i:
                step0, batch = pipe.get()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt_state, met = bundle.fn(params, opt_state, batch)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            dev_ms = sum(ev.self_device_time_total
                         for ev in _device_events(prof)) / 1e3
            if i == 0 and not torch.equal(met["loss"], per_call):
                raise AssertionError(
                    f"train: the prequant loss {float(met['loss'])} is not "
                    f"the per-call mxfp4_ste loss {float(per_call)}")
            met = {k: float(v) for k, v in met.items()}
            rows.append(dict(step=step0, loss=met["loss"],
                             grad_norm=met["grad_norm"], lr=met["lr"],
                             wall_ms=wall, device_ms=dev_ms,
                             busy=dev_ms / wall, tokens_s=tokens / wall * 1e3,
                             peak_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30))
            print(f"train step {json.dumps(rows[-1])}", flush=True)
        if not all(np.isfinite([r["loss"] for r in rows]
                               + [r["grad_norm"] for r in rows])):
            raise AssertionError("train: a loss or grad norm is not finite")
        ln_v = float(np.log(cfg.vocab_size))
        if abs(rows[0]["loss"] - ln_v) > TRAIN_LOSS_REL * ln_v:
            raise AssertionError(f"train: step 1's loss {rows[0]['loss']} is "
                                 f"not within 10% of ln(V) = {ln_v}")
        # one step with k=1 and one with k=2 from the same params and batch
        del opt_state
        _, batch = pipe.get()
        copy = adamw.tree_map(params, lambda t: t.detach().clone())
        _, st1, met1 = bundle.fn(copy, adamw.init(copy), batch)
        m1 = st1.m
        del st1, copy
        bundle2 = steps_mod.make_train_step(cfg, shape, quant="mxfp4_ste",
                                            microbatches=2, device=dev,
                                            dense_attn_max=TRAIN_DENSE_MAX)
        _, st2, met2 = bundle2.fn(params, adamw.init(params), batch)
        k2_db = _tree_sqnr(m1, st2.m)
        dead = _attn_ffn_grads_nonzero(cfg, m1)
        del st2, m1
        counts, _ = _read_counts()
        k2 = dict(loss_k1=float(met1["loss"]), loss_k2=float(met2["loss"]),
                  grad_norm_k1=float(met1["grad_norm"]),
                  grad_norm_k2=float(met2["grad_norm"]),
                  first_moment_min_sqnr_db=k2_db, zero_grad_weights=dead,
                  launches=counts)
        print(f"train k2 {json.dumps(k2)}", flush=True)
        if k2_db < TRAIN_K2_MIN_SQNR_DB:
            raise AssertionError(f"train: k=2 gradients at {k2_db} dB of "
                                 "k=1's")
        if dead:
            raise AssertionError(f"train: zero gradient into {dead}")
        if any(counts.values()):
            raise AssertionError(f"train: kernels launched: {counts}")
        _, batch = pipe.get()
        split = _train_step_split(cfg, bundle, params, batch, float(
            np.median([r["device_ms"] for r in rows[1:]])))
    finally:
        pipe.close()
    walls = [r["wall_ms"] for r in rows[1:]]
    summary = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
                   seq=shape.seq, batch=shape.batch, steps=len(rows),
                   loss_first=rows[0]["loss"], loss_last=rows[-1]["loss"],
                   prequant_loss_bitwise=True,
                   wall_ms_median=float(np.median(walls)),
                   device_ms_median=float(np.median(
                       [r["device_ms"] for r in rows[1:]])),
                   busy_median=float(np.median([r["busy"]
                                                for r in rows[1:]])),
                   tokens_s_median=float(np.median([r["tokens_s"]
                                                    for r in rows[1:]])),
                   peak_gib=max(r["peak_gib"] for r in rows), **split)
    print(f"train full width {json.dumps(summary)}", flush=True)
    return summary


def _kill_restart(run, tmp: str, tag: str) -> dict:
    """6 steps uninterrupted (directory ``a``) against 3 steps and a
    resume to 6 in a fresh directory (``b``), through ``run(steps,
    ckpt_dir)``; the two final states."""
    full = run(6, f"{tmp}/{tag}a")
    run(3, f"{tmp}/{tag}b")
    resumed = run(6, f"{tmp}/{tag}b")
    return {"start": resumed["trainer"].start_step, "states": [
        {"params": r["trainer"].params, "opt": r["trainer"].opt_state}
        for r in (full, resumed)]}


def train_launcher(dev) -> dict:
    """Phase 14b: the launcher's ``--mesh none`` path on the card
    (``launch.train.main`` with ``TRAIN_LAUNCH_ARGS``): the loss falls (the
    reference's own check, ``losses[0] > losses[-1] * 0.5``: the
    launcher's default AdamW warms up over 100 steps, so its 20 steps move
    the loss little; the update's values are held in phase 14c); a
    checkpoint written from the card restores on the CPU bitwise.
    Kill-restart (:func:`_kill_restart`) under
    ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
    is set before the first cuBLAS call, in :func:`main`): the final params
    and optimizer state bitwise equal; an op without a deterministic CUDA
    path raises, and the phase fails. The checkpoints live in a temp dir
    that is removed; the deterministic flag is restored."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    base = TRAIN_LAUNCH_ARGS + ["--device", dev.type]
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = train_mod.main(base + ["--ckpt", f"{tmp}/run"])
        out["launcher_s"] = time.perf_counter() - t0
        losses = res["losses"]
        out.update(final_step=res["final_step"], loss_first=losses[0],
                   loss_last=losses[-1])
        if not (res["final_step"] == 20 and losses[0] > losses[-1] * 0.5):
            raise AssertionError(f"train launcher: losses {losses}")
        trainer = res["trainer"]
        state = {"params": trainer.params, "opt": trainer.opt_state}
        on_cpu = CheckpointManager(f"{tmp}/run").restore(20, state,
                                                         device="cpu")
        out["card_to_cpu_bitwise"] = all(
            torch.equal(a.cpu(), b) for a, b in zip(adamw.leaves(state),
                                                     adamw.leaves(on_cpu)))
        if not out["card_to_cpu_bitwise"]:
            raise AssertionError("train: a checkpoint from the card does not "
                                 "restore on the CPU bitwise")

        def run(steps, ckpt):
            return train_mod.main(base + ["--steps", str(steps), "--ckpt",
                                          ckpt])

        prior = torch.are_deterministic_algorithms_enabled()
        try:
            torch.use_deterministic_algorithms(True)
            kr = _kill_restart(run, tmp, "det")
        finally:
            torch.use_deterministic_algorithms(prior)
        a, b = kr["states"]
        out["resume_start_step"] = kr["start"]
        out["kill_restart_bitwise"] = all(
            torch.equal(x, y) for x, y in zip(adamw.leaves(a),
                                              adamw.leaves(b)))
    print(f"train launcher {json.dumps(out)}", flush=True)
    if out["resume_start_step"] != 3:
        raise AssertionError("train: the resumed run did not start at 3")
    if not out["kill_restart_bitwise"]:
        raise AssertionError("train: kill-restart is not bitwise")
    return out


def train_tiny_agreement(dev) -> dict:
    """Phase 14c: tiny h2o-danube-1.8b with ``dense_attn_max`` 16 at seq 64
    (the prefill past it: the torch-op ``_flash_attn``, kernel E declined
    under autograd) trains 3 steps through ``make_train_step`` on the CPU,
    and the card takes each of those steps from the CPU's state before it
    with the same data, AdamW at ``TRAIN_TINY_OPT`` (no warmup; eps 1
    makes the update ~lr times the gradient, so the params move visibly
    and a small difference in a gradient does not flip an update's sign).
    Each step is held on its own: run freely, the two part after a step,
    as the weights' MXFP4 codes flip where the params differ in the last
    bits. Per step: losses within 1e-3 relative, each leaf's move and both
    moments >= ``TRAIN_TINY_MIN_SQNR_DB``; no kernel launched on the card;
    E's wrapper on CUDA inputs that require grad raises."""
    from repro_torch import configs as C
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = C.tiny(C.ARCHS[TRAIN_ARCH])
    shape = C.Shape(64, 4, "train")
    cpu = torch.device("cpu")
    opt = adamw.AdamWConfig(**TRAIN_TINY_OPT)
    step_fn = {d.type: steps_mod.make_train_step(
        cfg, shape, opt, device=d, dense_attn_max=16).fn for d in (cpu, dev)}

    def copy(tree, d):
        return adamw.tree_map(tree, lambda t: t.detach().to(d, copy=True))

    def state_to(st, d):
        return adamw.OptState(st.step.to(d, copy=True), copy(st.m, d),
                              copy(st.v, d))

    params = lm.init_model(cfg, torch.Generator().manual_seed(2))
    state = adamw.init(params)
    lc, lg, moves_db, m_db, v_db, rms = [], [], [], [], [], []
    _zero_counts()
    for s in range(3):
        before = copy(params, cpu)
        gp, gst, gmet = step_fn[dev.type](
            copy(before, dev), state_to(state, dev),
            make_batch(cfg, shape, 0, s, dev))
        params, state, met = step_fn["cpu"](params, state,
                                            make_batch(cfg, shape, 0, s, cpu))
        lc.append(float(met["loss"]))
        lg.append(float(gmet["loss"]))
        moved = [(w.detach() - b, g.detach().cpu() - b) for w, g, b in zip(
            adamw.leaves(params), adamw.leaves(gp), adamw.leaves(before))]
        moves_db.append(min(_sqnr_db(w, g) for w, g in moved))
        rms.append(float(torch.cat([w.flatten() for w, _ in moved])
                         .pow(2).mean().sqrt()))
        m_db.append(_tree_sqnr(state.m, gst.m))
        v_db.append(_tree_sqnr(state.v, gst.v))
    counts, _ = _read_counts()
    out = dict(losses_cpu=lc, losses_card=lg, moves_min_sqnr_db=moves_db,
               moves_rms=rms, m_min_sqnr_db=m_db, v_min_sqnr_db=v_db,
               launches=counts)
    q = torch.randn((1, 24, 4, 64), device=dev,
                    dtype=torch.bfloat16).requires_grad_(True)
    kv = torch.randn((1, 24, 2, 64), device=dev, dtype=torch.bfloat16)
    try:
        fa_ops.flash_attention(q, kv, kv)
        out["e_refuses_grad"] = False
    except RuntimeError as e:
        out["e_refuses_grad"] = "no backward" in str(e)
    print(f"train tiny card vs cpu {json.dumps(out)}", flush=True)
    if not np.allclose(lg, lc, rtol=1e-3, atol=0):
        raise AssertionError("train tiny: card and CPU losses disagree")
    if min(moves_db + m_db + v_db) < TRAIN_TINY_MIN_SQNR_DB:
        raise AssertionError("train tiny: card and CPU params disagree")
    if any(counts.values()):
        raise AssertionError(f"train tiny: kernels launched: {counts}")
    if not out["e_refuses_grad"]:
        raise AssertionError("flash_attention ran on inputs that require "
                             "grad")
    return out


# --------------------------------------------------------------- phase 15

def _route_counts() -> dict:
    """Each kernel's launches by route since the counts were zeroed (the
    single-route decode kernels under ``default``, as the dry-run's
    counter keys them); kernels that did not launch left out."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops

    out = {"mxfp4_matmul": dict(mm_ops.mxfp4_matmul.route_launches),
           "cim_linear": dict(cim_ops.cim_linear.route_launches),
           "flash_attention": dict(fa_ops.flash_attention.route_launches),
           "paged_decode": {"default": pops.paged_flash_decode.launches},
           "paged_decode_mx": {
               "default": pops.paged_flash_decode_mx.launches}}
    return {k: {r: n for r, n in v.items() if n}
            for k, v in out.items() if any(v.values())}


def _step_device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms a call, kernel launches a call) of a whole step:
    ``reps`` warmed calls under ``torch.profiler``, every kernel's device
    time summed over ``reps``. The profiler on the H100 machine now and
    then misses a launch in a long trace, which reads a call low by that
    kernel's time over ``reps`` (``launches`` shows it); an empty trace is
    taken again, and after three the call is timed by :func:`_device_ms`'s
    fallback (CUDA events, gaps included: an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            return (sum(ev.self_device_time_total for ev in events) / 1e3
                    / reps, sum(ev.count for ev in events) / reps)
    return _device_ms(fn, reps), float("nan")


def dry_run_step(dev, smi: str, name: str, arch: str, layers: int,
                 shape_t: tuple, quant: str) -> dict:
    """Phase 15, one step: ``launch.dryrun.run_cell`` predicts it on the
    one-card mesh (``make_local_mesh(1, 1)``, counted on ``meta``), then
    ``launch.steps.make_step`` builds the same step on the card from a
    clean memory state and it runs once, then ``DRY_REPS`` times profiled.
    Checks: ``argument_bytes`` equals the bytes of the allocated
    arguments; the predicted peak (arguments + the counter's temporaries)
    is within ``DRY_PEAK_REL`` of ``max_memory_allocated`` over the
    memory in use before the arguments; the counter's kernel calls by
    route equal the wrappers' launches by route; the measured device ms
    (:func:`_step_device_ms`) is at or above the predicted roofline time
    (no run beats its bound)."""
    from repro_torch import configs as C
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 1)
    shape = C.Shape(*shape_t)
    t0 = time.perf_counter()
    pred = dryrun.run_cell(arch, shape, False, quant=quant, verbose=False,
                           overrides={"n_layers": layers}, mesh=mesh)
    predict_s = time.perf_counter() - t0
    cfg = dataclasses.replace(C.ARCHS[arch], n_layers=layers)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle = steps_mod.make_step(cfg, mesh, shape, quant=quant, device=dev)
    allocated = sum(t.numel() * t.element_size()
                    for t in _leaves(list(bundle.args)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = bundle.fn(*bundle.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launched = _route_counts()
    del out
    step_ms, step_launches = _step_device_ms(
        lambda: bundle.fn(*bundle.args), DRY_REPS)
    mem = pred["memory"]
    roofline_ms = max(pred["t_compute_s"], pred["t_memory_s"]) * 1e3
    row = dict(
        step=name, arch=arch, layers=layers, seq=shape.seq,
        batch=shape.batch, quant=quant, card=smi,
        argument_bytes_predicted=mem["argument_bytes"],
        argument_bytes_allocated=allocated,
        peak_bytes_predicted=mem["peak_bytes"], peak_bytes_measured=peak,
        peak_ratio=mem["peak_bytes"] / peak,
        kernel_calls_predicted=pred["kernel_calls"],
        kernel_launches=launched,
        roofline_ms=roofline_ms, dominant=pred["dominant"],
        wholegraph_ms=max(pred["wholegraph"]["t_compute_s"],
                          pred["wholegraph"]["t_memory_s"]) * 1e3,
        flops_predicted=pred["hlo_flops_per_dev"],
        bytes_predicted=pred["hlo_bytes_per_dev"],
        device_ms=step_ms, kernel_launches_a_call=step_launches,
        measured_over_roofline=step_ms / roofline_ms,
        predict_s=predict_s)
    print(f"dry run {json.dumps(row)}", flush=True)
    del bundle
    if allocated != mem["argument_bytes"]:
        raise AssertionError(f"dry run {name}: argument_bytes "
                             f"{mem['argument_bytes']} != allocated "
                             f"{allocated}")
    if abs(row["peak_ratio"] - 1.0) > DRY_PEAK_REL:
        raise AssertionError(f"dry run {name}: predicted peak "
                             f"{mem['peak_bytes']} vs measured {peak}")
    if pred["kernel_calls"] != launched:
        raise AssertionError(f"dry run {name}: kernel calls "
                             f"{pred['kernel_calls']} vs launches {launched}")
    if step_ms < roofline_ms:
        raise AssertionError(f"dry run {name}: {step_ms} device ms beat the "
                             f"roofline's {roofline_ms}")
    return row


def dry_run(dev, smi: str) -> dict:
    """Phase 15: the three ``DRY_STEPS`` (:func:`dry_run_step`), then the
    dry-run on this host for ``DRY_SWEEP``, one cell a family but audio
    on the single pod (its seconds; every cell must count)."""
    from repro_torch.launch import dryrun

    rows = {s[0]: dry_run_step(dev, smi, *s) for s in DRY_STEPS}
    t0 = time.perf_counter()
    cells = [dryrun.run_cell(a, s, False, verbose=False)
             for a, s in DRY_SWEEP]
    sweep = dict(cells=len(cells), seconds=time.perf_counter() - t0,
                 rows=[{k: c[k] for k in ("arch", "shape", "mesh",
                                          "dominant", "useful_flops_ratio")}
                       | {"fits_80GB": c["memory"]["fits_80GB"]}
                       for c in cells])
    print(f"dry run sweep {json.dumps(sweep)}", flush=True)
    return dict(rows, sweep=sweep)


# --------------------------------------------------------------- phase 16

def train_sharded_nccl(dev, smi: str) -> dict:
    """Phase 16a: the sharded train step over ``torch.distributed`` on the
    card. Phase 14's one-device step (``make_train_step(cfg, shape)``,
    k = 1) takes ``SHARD_STEPS`` steps from seed 0's init on the
    pipeline's batches; then an NCCL group of one rank (a ``HashStore``:
    NCCL takes one rank a GPU) and ``make_train_step`` on
    ``make_local_mesh(1, 1)`` over it (its own init from seed 0, cut into
    blocks: at world 1 the whole) take the same steps, each profiled.
    Checks: every loss, and the final parameters, m and v, ``torch.equal``
    to the one-device run's (every collective a copy at world 1); the
    bytes of the allocated arguments equal ``steps.args_bytes`` of the
    dry-run's bundle on that mesh (``meta``). Both runs are deterministic
    (``torch.use_deterministic_algorithms``, as phase 14b). Prints the
    collectives by kind a step (count, result bytes, ring wire bytes),
    step and device ms and peak GiB, and the one-device steps' wall ms
    and peak GiB beside them (``train sharded``). The group is
    destroyed."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs as C
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(C.ARCHS[TRAIN_ARCH], n_layers=TRAIN_LAYERS)
    shape = C.Shape(TRAIN_SEQ, TRAIN_BATCH, "train")
    kw = dict(quant="mxfp4_ste", microbatches=1,
              dense_attn_max=TRAIN_DENSE_MAX)
    batches = [make_batch(cfg, shape, 0, i, device=dev)
               for i in range(SHARD_STEPS)]
    prior = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        one = steps_mod.make_train_step(cfg, shape, device=dev, **kw)
        params, _ = steps_mod.param_structs(cfg, device=dev)
        state = adamw.init(params)
        want_loss, one_rows = [], []
        for b in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, met = one.fn(params, state, b)
            torch.cuda.synchronize()
            one_rows.append(dict(
                wall_ms=(time.perf_counter() - t0) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            want_loss.append(met["loss"].clone())
        want = {"params": adamw.leaves(params), "m": adamw.leaves(state.m),
                "v": adamw.leaves(state.v)}
        del params, state, one
        torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = make_local_mesh(1, 1)
            pred = steps_mod.make_train_step(
                cfg, make_local_mesh(1, 1, device="meta"), shape,
                device="meta", **kw)
            predicted = steps_mod.args_bytes(pred.args, pred.shardings,
                                             pred.mesh)
            del pred
            gc.collect()
            torch.cuda.empty_cache()
            bundle = steps_mod.make_train_step(cfg, mesh, shape, **kw)
            params, state, _ = bundle.args
            allocated = sum(t.numel() * t.element_size()
                            for t in _leaves(list(bundle.args)))
            rows, losses = [], []
            for b in batches:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    params, state, met = bundle.fn(params, state, b)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                events = _device_events(prof)
                nccl = sum(ev.self_device_time_total for ev in events
                           if "nccl" in ev.key.lower()) / 1e3
                losses.append(met["loss"].clone())
                rows.append(dict(
                    wall_ms=wall, device_ms=sum(
                        ev.self_device_time_total for ev in events) / 1e3,
                    nccl_ms=nccl, loss=float(met["loss"]),
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            got = {"params": adamw.leaves(params), "m": adamw.leaves(state.m),
                   "v": adamw.leaves(state.v)}
            coll = {k: {"count": v[0] / SHARD_STEPS,
                        "bytes": v[2] / SHARD_STEPS,
                        "wire_bytes": v[1] / SHARD_STEPS}
                    for k, v in bundle.collectives.by_kind.items()}
            by_axis = {a: {k: v[0] / SHARD_STEPS
                           for k, v in st.by_kind.items()}
                       for a, st in bundle.axis_collectives.items()}
            tp = bundle.ctx.tp
            link_ms = bundle.collectives.link_s() / SHARD_STEPS * 1e3
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(prior)
    equal = {name: all(torch.equal(a, b) for a, b in zip(want[name],
                                                          got[name]))
             for name in want}
    equal["loss"] = all(torch.equal(a, b) for a, b in zip(want_loss, losses))
    walls = [r["wall_ms"] for r in rows[1:]]
    out = dict(arch=cfg.name, layers=cfg.n_layers, seq=shape.seq,
               batch=shape.batch, world=1, backend="nccl", card=smi,
               mesh=[1, 1], tensor_parallel=tp is not None,
               collective_counts_by_axis=by_axis,
               steps=rows, one_device_steps=one_rows, equal=equal,
               argument_bytes_allocated=allocated,
               argument_bytes_predicted=predicted,
               collectives_a_step=coll, link_ms_a_step=link_ms,
               wall_ms_median=float(np.median(walls)),
               device_ms_median=float(np.median(
                   [r["device_ms"] for r in rows[1:]])),
               peak_gib=max(r["peak_gib"] for r in rows))
    print(f"train sharded {json.dumps(out)}", flush=True)
    del want, got, params, state, bundle
    if not all(equal.values()):
        raise AssertionError(f"train sharded: not torch.equal to the "
                             f"one-device step: {equal}")
    if allocated != predicted:
        raise AssertionError(f"train sharded: argument bytes {allocated} "
                             f"!= args_bytes {predicted}")
    return out


def _c_routes(m: int) -> tuple:
    """``mxfp4_matmul``'s routes that take ``m`` bf16 rows."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    return ("fma",) + (("mma",) if m <= mm_ops.MMA_MAX_M else ("wgmma",))


def check_c_f32_out(dev) -> list:
    """Phase 17a: kernel C with ``out_dtype=float32`` (a row-parallel
    linear's partial) at ``ROWPAR_SHAPES`` x ``ROWPAR_M``: on every route
    that takes the rows, the f32 output against the plain version's
    (``mxfp4_matmul_ref(out_dtype=float32)``) within
    ``ROWPAR_F32_TOL`` x its largest magnitude (the f32 sums' order; a
    bf16 rounding is 2^-9 of each value), at least ``ROWPAR_OFF_BF16`` of
    the f32 outputs off the bf16 grid (a kernel that rounded to bf16 and
    stored f32 would have none), and the bf16 output ``torch.equal`` to
    the f32 one cast to bf16; the picked route timed beside its bound,
    the plain version and ``torch.mm`` with f32 out on the dequantized
    weight (the library call). A disagreement raises."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.mxfp4_matmul.ref import mxfp4_matmul_ref
    from repro_torch.layers import backends

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for k, n in ROWPAR_SHAPES:
        packed = backends._quantize_packed(
            torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        codes, exps = packed["codes"], packed["exps"]
        w_bf16 = backends._dequant_packed(codes, exps)
        for m in ROWPAR_M:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            ref = mxfp4_matmul_ref(x, codes, exps, f32)
            limit = ROWPAR_F32_TOL * float(ref.abs().max())
            cast_equal, errs, off_bf16 = {}, {}, {}
            for r in _c_routes(m):
                got = mm_ops._launch(x, codes, exps, route=r, out_dtype=f32)
                half = mm_ops._launch(x, codes, exps, route=r)
                cast_equal[r] = bool(torch.equal(half, got.to(torch.bfloat16)))
                errs[r] = float((got - ref).abs().max())
                # an f32 store of a bf16-rounded sum would be bf16-exact
                off_bf16[r] = float(
                    (got != got.to(torch.bfloat16).float()).float().mean())
                if errs[r] > limit or off_bf16[r] < ROWPAR_OFF_BF16:
                    raise AssertionError(
                        f"mxfp4_matmul f32 out, {r} route, at {(m, k, n)}: "
                        f"max |err| {errs[r]} (limit {limit}), "
                        f"{off_bf16[r]} of the outputs off the bf16 grid "
                        f"(at least {ROWPAR_OFF_BF16})")
            route = mm_ops.pick_route(m, k, n, x.dtype)
            bound, by = _bound_ms(*mm_ops.cost(m, k, n, 2, 4))
            row = dict(
                case="f32 out", m=m, k=k, n=n, route=route,
                bf16_is_cast_f32=cast_equal, max_abs_err=max(errs.values()),
                max_abs_err_by_route=errs, limit=limit,
                off_bf16_by_route=off_bf16,
                ms=_device_ms(lambda: mm_ops.mxfp4_matmul(
                    x, codes, exps, out_dtype=f32), 20),
                call_ms=_time_ms(lambda: mm_ops.mxfp4_matmul(
                    x, codes, exps, out_dtype=f32), 20),
                plain_ms=_device_ms(
                    lambda: mxfp4_matmul_ref(x, codes, exps, f32), 1),
                bound_ms=bound, bound_by=by,
                library_ms=_device_ms(lambda: torch.mm(
                    x, w_bf16, out_dtype=f32), 20))
            print("mxfp4_matmul f32 out", json.dumps(row), flush=True)
            if not all(cast_equal.values()):
                raise AssertionError(f"mxfp4_matmul: the bf16 output is not "
                                     f"the f32 one cast at {(m, k, n)}: "
                                     f"{cast_equal}")
            rows.append(row)
        del packed, codes, exps, w_bf16
    return rows


def _a_slices(x, w, slices: int) -> list:
    """(x's K-slice, its rows of the K-major weight, K-major) ``slices``
    ways: the blocks of a row-parallel linear's model ranks."""
    from repro_torch.core import mx as mxlib

    k = x.shape[1]
    ks = k // slices
    return [(x[:, i * ks:(i + 1) * ks].contiguous(),
             mxlib.MXW(mxlib.kmajor(w.codes[i * ks:(i + 1) * ks]),
                       mxlib.kmajor(w.exps[i * ks // 32:(i + 1) * ks // 32])))
            for i in range(slices)]


def _a_sums_check(x, w, cal, cfg, routes) -> dict:
    """Kernel A's pass sums of ``ROWPAR_SLICES`` K-slices of ``x @ w`` on
    each of ``routes``: each slice's sums ``torch.equal`` to the plain
    version's (``core.cim.pass_sums``), and their sum, read out
    (``core.cim.read_out_sums``), against A's whole output on the same
    route: rows equal, and the rows that differ (only where the whole
    one's ordered f32 sum rounds: ``guard_rows``) counted."""
    from repro_torch.core import cim as cimlib
    from repro_torch.kernels.cim_linear import ops as cim_ops

    parts = _a_slices(x, w, ROWPAR_SLICES)
    out = {}
    for r in routes:
        counter = cim_ops.guard_rows(x.device)
        counter.zero_()
        whole = cim_ops._launch(x, w, cal, cfg, route=r)
        sums, plain_equal = None, True
        for xs, ws in parts:
            got = cim_ops._launch(xs, ws, cal, cfg, route=r, sums=True)
            plain_equal &= bool(torch.equal(
                got, cimlib.pass_sums(xs, ws, cal, cfg)))
            sums = got if sums is None else sums + got
        y = cimlib.read_out_sums(sums, cal, cfg)
        torch.cuda.synchronize()
        differ = (y != whole).any(-1)
        out[r] = dict(plain_equal=plain_equal,
                      rows_differ=int(differ.sum()),
                      guard_rows=int(counter),
                      max_abs_diff=float((y - whole).abs().max()))
    return out


def check_a_sums(dev) -> list:
    """Phase 17b: kernel A's pass-sums mode at ``ROWPAR_SHAPES`` (the
    slice's K) x ``ROWPAR_M``: on both routes, the sums of
    ``ROWPAR_SLICES`` K-slices bitwise the plain version's, and their sum
    read out ``torch.equal`` to A's whole output (the whole K) in every
    row (a row whose one-device ordered sum rounds may differ; none of
    these inputs has one); then the constructed rounding input at
    K = 18432 (its row 0 rounds): the split sums read out differ from the
    whole output in that one guarded row, which is counted. The picked
    route of the sums mode timed at the slice's shape beside its bound
    and the plain version (no library call computes it). A disagreement
    raises."""
    from repro_torch.core import cim as cimlib
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.cim_linear import ops as cim_ops

    gen = torch.Generator(device=dev).manual_seed(18)
    cfg = cimlib.CIMConfig()
    rows = []
    for ks, n in ROWPAR_SHAPES:
        k = ks * ROWPAR_SLICES
        w = mxlib.quantize_w(torch.randn((k, n), generator=gen, device=dev)
                             * k ** -0.5)
        for m in ROWPAR_M:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            cal = cimlib.calibrate_rowhist([x.float()], w, cfg)
            routes = ("splitk",) + (("wgmma",) if m >= cim_ops.TC_MIN_M
                                    else ())
            by_route = _a_sums_check(x, w, cal, cfg, routes)
            xs, ws = _a_slices(x, w, ROWPAR_SLICES)[0]
            route = cim_ops._sums_route(m, ks, n, cfg.cm_bits)
            bound, by = _bound_ms(*cim_ops.cost(m, ks, n, 2, sums=True))
            row = dict(
                case="pass sums", m=m, k=ks, n=n, whole_k=k, route=route,
                routes=by_route, max_abs_err=0.0,
                ms=_device_ms(lambda: cim_ops.cim_linear(
                    xs, ws, cal, cfg=cfg, sums=True), 20),
                call_ms=_time_ms(lambda: cim_ops.cim_linear(
                    xs, ws, cal, cfg=cfg, sums=True), 20),
                plain_ms=_device_ms(
                    lambda: cimlib.pass_sums(xs, ws, cal, cfg), 1),
                bound_ms=bound, bound_by=by, library_ms=None)
            print("cim_linear pass sums", json.dumps(row), flush=True)
            bad = {r: v for r, v in by_route.items()
                   if not v["plain_equal"] or v["rows_differ"]}
            if bad:
                raise AssertionError(f"cim_linear pass sums at {(m, ks, n)}: "
                                     f"{bad}")
            rows.append(row)
        del w
    x, w, cal, rcfg = _rounding_input(dev)
    rounding = _a_sums_check(x, w, cal, rcfg, ("splitk",))["splitk"]
    print("cim_linear pass sums rounding", json.dumps(rounding), flush=True)
    if not rounding["plain_equal"] or rounding["rows_differ"] != 1 \
            or rounding["guard_rows"] != 1:
        raise AssertionError(f"cim_linear pass sums, rounding input: "
                             f"{rounding} (expected its one guarded row to "
                             "differ)")
    return rows


def _partial_pages(dev, dims, w: int, mx: bool, gen):
    """Phase 17d's q and pages of ``w`` slots (10 pool rows), as
    ``check_paged_decode`` / ``check_paged_decode_float`` make them."""
    from repro_torch.core import mx as mxlib
    from repro_torch.kernels.paged_attention import layout

    lanes, hkv, g, dh = dims
    kv = (torch.randn((10, w, 2 * hkv, dh), generator=gen, device=dev)
          * 0.7).to(torch.bfloat16)
    q = (torch.randn((lanes, hkv, g, dh), generator=gen, device=dev)
         * 0.7).to(torch.bfloat16)
    if not mx:
        return q, {"kv": kv}
    return mxlib.fake_quant(q), {"quant": layout.quant_page_full(
        *layout.split_kv(kv))}


def _page_block(pages: dict, r: int, wl: int) -> dict:
    """Block ``r`` of ``wl`` slots of the pages, contiguous (a rank's)."""
    if "kv" in pages:
        return {"kv": pages["kv"][:, r * wl:(r + 1) * wl].contiguous()}
    q = pages["quant"]
    return {"quant": {
        "kv_codes": q["kv_codes"][:, r * wl:(r + 1) * wl].contiguous(),
        "k_exps": q["k_exps"][:, r * wl:(r + 1) * wl].contiguous(),
        "v_exps": q["v_exps"][:, r * wl // 32:(r + 1) * wl // 32]
        .contiguous()}}


def _partial_plain(q, pages, rows, lengths, scale: float, bk: int):
    from repro_torch.kernels.paged_attention import ref as pref

    if "kv" in pages:
        return pref.paged_flash_decode_ref(q, pages["kv"], rows, lengths,
                                           scale=scale, bk=bk, partial=True)
    qu = pages["quant"]
    return pref.paged_flash_decode_mx_ref(
        q, qu["kv_codes"], qu["k_exps"], qu["v_exps"], rows, lengths,
        scale=scale, bk=bk, partial=True)


def _efficient_lse_ms(q, kv, rows, lengths, scale: float):
    """The library call that returns the same (o, lse) of float pages: the
    memory-efficient SDPA with its log-sum-exp, the lanes' pages gathered,
    their KV heads repeated over the query heads and the length mask built
    outside the timing; None (and why) where it does not take the shape."""
    from repro_torch.kernels.paged_attention import layout

    lanes, hkv, g, dh = q.shape
    kd, vd = layout.split_kv(kv[rows.long()])  # [L, W, Hkv, Dh]
    kd, vd = (t.transpose(1, 2).repeat_interleave(g, 1).contiguous()
              for t in (kd, vd))
    qs = q.reshape(lanes, hkv * g, 1, dh)
    w = kv.shape[1]
    bias = torch.zeros((lanes, hkv * g, 1, w), device=q.device,
                       dtype=q.dtype)
    bias.masked_fill_((torch.arange(w, device=q.device)[None, :]
                       >= lengths[:, None])[:, None, None, :], float("-inf"))
    try:
        def call():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qs, kd, vd, bias, True, scale=scale)
        call()
        torch.cuda.synchronize()
        return _device_ms(call, 20), None
    except (RuntimeError, TypeError) as e:
        return None, f"aten._scaled_dot_product_efficient_attention: {e}"


def check_decode_partial(dev) -> list:
    """Phase 17d: kernels B (``paged_decode_mx``) and D (``paged_decode``)
    in their partial mode at ``PARTIAL_CASES``: the page cut in its blocks
    (each a rank's, contiguous), each block's (o, lse) against the plain
    version's on the same inputs: -inf at the same heads; lse within
    ``ROWPAR_F32_TOL`` x its largest magnitude; B's o within
    ``ROWPAR_F32_TOL`` x max |plain o| (the same chunks and P blocks, f32
    sums in another order), D's within its bf16 mode's gates
    (``PARTIAL_FLOAT_MIN_DB``, ``PARTIAL_FLOAT_ATOL``). The whole page in
    one block: o cast to bf16 ``torch.equal`` to the bf16 mode. The
    blocks combined (``seq_parallel.combine_partials``) against the dense
    function, within ``PARTIAL_DROP_DB`` of the whole page's kernel. Block
    0's launch timed beside its bound (the partial mode's bytes: o and lse
    f32), the plain version and, for D, the memory-efficient SDPA with its
    log-sum-exp. A disagreement raises."""
    from repro_torch.distributed import seq_parallel as spl
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention import ref as pref

    gen = torch.Generator(device=dev).manual_seed(33)
    rows_out = []
    for arch, dims, w, n, lens in PARTIAL_CASES:
        lanes, hkv, g, dh = dims
        scale = dh ** -0.5
        rows = torch.tensor([7, 0, 3, 9], device=dev, dtype=torch.int32)
        lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        wl = w // n
        for name, mx in (("paged_decode_mx", True), ("paged_decode", False)):
            q, pages = _partial_pages(dev, dims, w, mx, gen)
            whole = pops.ragged_paged_decode(q, rows, lengths, scale=scale,
                                             **pages)
            one_o, _ = pops.ragged_paged_decode(q, rows, lengths, scale=scale,
                                                partial=True, **pages)
            cast_equal = bool(torch.equal(one_o.to(torch.bfloat16), whole))
            os_, ls_, o_err, lse_err, sq_plain, blocks = [], [], [], [], [], []
            inf_same = True
            for r in range(n):
                blk = _page_block(pages, r, wl)
                bl = torch.clamp(lengths - r * wl, 0, wl).to(torch.int32)
                o, lse = pops.ragged_paged_decode(q, rows, bl, scale=scale,
                                                  partial=True, **blk)
                po, pl = _partial_plain(q, blk, rows, bl, scale,
                                        pops.pick_bk(wl))
                torch.cuda.synchronize()
                fin = torch.isfinite(pl)
                inf_same &= bool(torch.equal(fin, torch.isfinite(lse)))
                o_err.append(float((o - po).abs().max()))
                lse_err.append(float((lse[fin] - pl[fin]).abs().max())
                               if fin.any() else 0.0)
                live = fin.any(-1).any(-1)
                sq_plain.append(_sqnr_db(po[live], o[live])
                                if live.any() else float("inf"))
                os_.append(o)
                ls_.append(lse)
                blocks.append((blk, bl, po, pl))
            got = spl.combine_partials(torch.stack(os_), torch.stack(ls_))
            dense = pref.ragged_paged_decode_ref(
                q, rows, lengths, scale=scale, **pages).float()
            live = lengths > 0
            sq_comb = _sqnr_db(dense[live], got.float()[live])
            sq_whole = _sqnr_db(dense[live], whole.float()[live])
            o_lim = [ROWPAR_F32_TOL * float(b[2].abs().max()) for b in blocks]
            lse_lim = [ROWPAR_F32_TOL * float(b[3][torch.isfinite(b[3])]
                                              .abs().max())
                       if torch.isfinite(b[3]).any() else 0.0
                       for b in blocks]
            if mx:
                o_ok = all(e <= lim for e, lim in zip(o_err, o_lim))
            else:
                o_ok = (min(sq_plain) > PARTIAL_FLOAT_MIN_DB
                        and max(o_err) <= PARTIAL_FLOAT_ATOL)
            ok = (cast_equal and inf_same and o_ok
                  and all(e <= lim for e, lim in zip(lse_err, lse_lim))
                  and sq_comb >= sq_whole - PARTIAL_DROP_DB
                  and bool((got[~live] == 0).all()))
            blk, bl, _, _ = blocks[0]
            lens0 = bl.tolist()
            if mx:
                cost = pops.cost_mx(lens0, hkv, g, dh,
                                    blk["quant"]["kv_codes"].shape[-1],
                                    blk["quant"]["k_exps"].shape[-1], True)
                lib_ms, lib_why = None, "no PyTorch call decodes MXFP4 pages"
            else:
                cost = pops.cost_float(lens0, hkv, g, dh, True)
                lib_ms, lib_why = _efficient_lse_ms(q, blk["kv"], rows, bl,
                                                    scale)
            bound, by = _bound_ms(*cost)

            def kernel(blk=blk, bl=bl):
                return pops.ragged_paged_decode(q, rows, bl, scale=scale,
                                                partial=True, **blk)

            row = dict(
                case="partial", arch=arch, name=name, lanes=lanes, hkv=hkv,
                g=g, dh=dh, w=w, blocks=n, w_block=wl, lengths=lens,
                block0_lengths=lens0, bf16_is_cast_f32=cast_equal,
                inf_same=inf_same, o_err_by_block=o_err, o_limit=o_lim,
                lse_err_by_block=lse_err, lse_limit=lse_lim,
                o_sqnr_vs_plain_db=sq_plain, combined_vs_dense_db=sq_comb,
                whole_vs_dense_db=sq_whole, ok=ok,
                max_abs_err=max(o_err + lse_err), ms=_device_ms(kernel, 50),
                call_ms=_time_ms(kernel, 50),
                plain_ms=_device_ms(lambda: _partial_plain(
                    q, blk, rows, bl, scale, pops.pick_bk(wl)), 5),
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library_note=lib_why)
            print(f"{name} partial", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"{name} partial mode disagrees at "
                                     f"{arch} W={w} in {n}: {row}")
            rows_out.append(row)
    return rows_out


def _serve_shard_inputs(cfg, dev) -> dict:
    """Phase 17c's inputs (seed 17): the prefill's ids, the decode step's
    ids, the paged step's rows, ids and positions."""
    gen = torch.Generator(device=dev).manual_seed(17)
    b, s = SERVE_SHARD_BATCH, SERVE_SHARD_SEQ

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             dtype=torch.int32, device=dev)

    return {"batch": {"ids": ids(b, s)}, "ids": ids(b, 1),
            "pos": torch.tensor(s, dtype=torch.int32, device=dev),
            "rows": torch.tensor([1, 3, 5, PAGED_SLOTS + 3],
                                 dtype=torch.int32, device=dev),
            "paged_ids": ids(b, 1),
            "paged_pos": torch.tensor([s * 3 // 4, 17, s - 1, 0],
                                      dtype=torch.int32, device=dev)}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def serve_sharded_one(backend: str, model, smi: str) -> dict:
    """Phase 17c, one backend: the three serving builders on
    ``make_local_mesh(1, 1)`` over the NCCL group (their arguments on
    ``meta``; the served model's weights cut by ``steps.shard_params``,
    a copy at (1, 1)) against the one-device bundles on the same inputs:
    prefill into fresh caches, one decode step over copies of the
    prefill's caches, the paged step (legacy, and fused) over copies of
    one random pool. Ids and caches ``torch.equal``. The launch counters
    are zeroed before the sharded steps and read after: C (``mxfp4``) or
    A (``cim``) must launch, and on the fused pool D or B. Device ms of
    each sharded step (one traced call after the compared one), the
    collectives recorded (every one a copy at (1, 1)). Then the same
    steps with ``model_forms``: the row-parallel ``wo`` and ``w2`` run
    C's f32 out or A's pass sums, q, k and v are gathered, the head is
    vocab-parallel and the fused decode runs D's or B's partial mode at
    one block (its combine over identity collectives), every model
    collective a copy; ids and caches ``torch.equal`` to the one-device
    bundles, and the counters, zeroed before and read after, must show
    C's f32 or A's sums mode launched, and the partial mode once a layer
    (``forms_launches``)."""
    from repro_torch import configs as C
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm

    cfg, params, ctx = model
    dev = next(_leaves(params)).device
    quant = ctx.quant
    one = make_local_mesh(1, 1, device="meta")  # not over the group
    mesh = make_local_mesh(1, 1)
    inp = _serve_shard_inputs(cfg, dev)
    b, s = SERVE_SHARD_BATCH, SERVE_SHARD_SEQ
    pre = C.Shape(s, b, "prefill")
    dec = C.Shape(s, b, "decode")
    kw = dict(quant=quant, device="meta")
    blocks = {mode: steps_mod.shard_params(cfg, mesh, params, mode,
                                           batch_size=b)[0]
              for mode in ("prefill", "decode")}
    mx = ctx.hybrid_digital_sdpa
    layouts = ("legacy", "fused")
    pools = {}
    for layout in layouts:
        pools[layout] = lm.init_cache(cfg, PAGED_SLOTS + b, s, mx_digital=mx,
                                      fused=layout == "fused", device=dev)
        _random_pool(pools[layout], torch.Generator(dev).manual_seed(5))

    def clone(tree):
        return [[{k: v.clone() for k, v in layer.items()} for layer in seg]
                for seg in tree]

    def runs(m, forms):
        fkw = dict(kw, model_forms=forms)
        pb = steps_mod.make_prefill_step(cfg, m, pre, **fkw)
        db = steps_mod.make_decode_step(cfg, m, dec, **fkw)
        kb = {lay: steps_mod.make_paged_decode_step(
            cfg, m, dec, PAGED_SLOTS, kv_layout=lay, **fkw)
            for lay in layouts}
        return pb, db, kb

    out = {"backend": backend, "layers": cfg.n_layers, "card": smi}
    results = {}
    for label, m in (("one", one), ("sharded", mesh), ("forms", mesh)):
        pb, db, kb = runs(m, label == "forms")
        p_pre = params if label == "one" else blocks["prefill"]
        p_dec = params if label == "one" else blocks["decode"]
        step_calls = {
            "prefill": lambda: pb.fn(p_pre, inp["batch"]),
            "decode": lambda: db.fn(p_dec, dec_caches, inp["ids"],
                                    inp["pos"])}
        for lay in kb:
            step_calls[f"paged {lay}"] = (
                lambda lay=lay: kb[lay].fn(p_dec, paged[lay], inp["rows"],
                                           inp["paged_ids"],
                                           inp["paged_pos"]))
        if label != "one":
            _zero_counts()
        res = {}
        res["prefill"] = step_calls["prefill"]()
        dec_caches = clone(res["prefill"][1])
        res["decode"] = step_calls["decode"]()
        paged = {lay: clone(pools[lay]) for lay in kb}
        for lay in kb:
            res[f"paged {lay}"] = step_calls[f"paged {lay}"]()
        torch.cuda.synchronize()
        if label == "forms":
            out["forms_launches"] = _read_counts()[0] | _mode_counts()
            out["forms_device_ms"] = {}
            for name, fn in step_calls.items():
                dec_caches = clone(res["prefill"][1])
                paged = {lay: clone(pools[lay]) for lay in kb}
                out["forms_device_ms"][name] = _device_ms(fn, 1)
        if label == "sharded":
            launches, mm_routes = _read_counts()
            out["launches"] = launches
            out["mxfp4_matmul_routes"] = mm_routes
            out["cim_linear_routes"] = _cim_routes()
            dec_caches = clone(res["prefill"][1])
            paged = {lay: clone(pools[lay]) for lay in layouts}
            out["device_ms"] = {name: _device_ms(fn, 1)
                                for name, fn in step_calls.items()}
            out["collectives"] = {
                name: {a: {k: v[0] for k, v in st.by_kind.items()}
                       for a, st in bd.axis_collectives.items()}
                for name, bd in (("prefill", pb), ("decode", db),
                                 ("paged legacy", kb["legacy"]))}
        results[label] = {k: (v[0].clone(), v[1]) for k, v in res.items()}
        del pb, db, kb
    for label in ("sharded", "forms"):
        out["equal" if label == "sharded" else "forms_equal"] = {
            name: bool(torch.equal(results["one"][name][0],
                                   results[label][name][0])
                       and _same(results["one"][name][1],
                                 results[label][name][1]))
            for name in results[label]}
    lin = "cim_linear" if backend == "cim" else "mxfp4_matmul"
    att = "paged_decode_mx" if backend == "cim" else "paged_decode"
    mode = "cim_linear sums" if backend == "cim" else "mxfp4_matmul f32"
    print(f"sharded serve {json.dumps(out)}", flush=True)
    for key in ("equal", "forms_equal"):
        if not all(out[key].values()):
            raise AssertionError(f"sharded serve {backend}: not torch.equal "
                                 f"to the one-device bundles ({key}): "
                                 f"{out[key]}")
    if not (out["launches"][lin] and out["launches"][att]):
        raise AssertionError(f"sharded serve {backend}: {lin} / {att} did "
                             f"not launch: {out['launches']}")
    if not out["forms_launches"][mode]:
        raise AssertionError(f"sharded serve {backend}: {mode} did not "
                             f"launch under model_forms: "
                             f"{out['forms_launches']}")
    if out["forms_launches"][f"{att} partial"] != cfg.n_layers:
        raise AssertionError(f"sharded serve {backend}: {att}'s partial "
                             f"mode launched "
                             f"{out['forms_launches'][f'{att} partial']} "
                             f"times in the fused step under model_forms, "
                             f"not once a layer ({cfg.n_layers})")
    return out


def serve_sharded(dev, smi: str) -> dict:
    """Phase 17c: an NCCL group of one rank (a ``HashStore``), then
    :func:`serve_sharded_one` for each backend of ``SERVE_SHARD_ARGS``,
    its model built by the launcher's ``build_model``; the group is
    destroyed."""
    import torch.distributed as dist

    from repro_torch.launch import serve

    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        for backend, args in SERVE_SHARD_ARGS.items():
            model = serve.build_model(serve.build_parser().parse_args(args))
            out[backend] = serve_sharded_one(backend, model[:3], smi)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def rowpar_kernel_entries(c_rows: list, a_rows: list, p_rows: list,
                          runs: dict) -> list:
    """The kernels line's entries of phase 17: C's f32 output and A's pass
    sums at the row-parallel shapes, B's and D's partial mode at the
    decode shapes (block 0 of the page), each with that mode's launches
    in phase 17c's ``model_forms`` steps (the run whose row-parallel
    linears and fused decode take it)."""
    out = []
    for row in p_rows:
        name = row["name"]
        run = "cim" if name == "paged_decode_mx" else "mxfp4"
        line = 275 if name == "paged_decode_mx" else 228
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/paged_attention/kernel.py:{line}",
            "launches": runs[run]["forms_launches"][f"{name} partial"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "call_ms": row["call_ms"], "kernel_route": "partial",
            "shape": f"{row['arch']}: L={row['lanes']} Hkv={row['hkv']} "
                     f"G={row['g']} Dh={row['dh']} W={row['w']} in "
                     f"{row['blocks']}, block 0 lengths "
                     f"{row['block0_lengths']} (partial)"})
    for name, rows, replaces, run, mode in (
            ("mxfp4_matmul", c_rows,
             "src/repro/kernels/mxfp4_matmul/kernel.py:69", "mxfp4",
             "mxfp4_matmul f32"),
            ("cim_linear", a_rows,
             "src/repro/kernels/cim_linear/kernel.py:127", "cim",
             "cim_linear sums")):
        for row in rows:
            out.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": runs[run]["forms_launches"][mode],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "call_ms": row["call_ms"], "kernel_route": row["route"],
                "shape": f"M={row['m']} K={row['k']} N={row['n']} "
                         f"({row['case']})"})
    return out


def _random_pool(pool, gen) -> None:
    """Fill every leaf of a pool with random values of its dtype (float
    leaves normal, scaled by 1/2; integer leaves in [0, 16))."""
    for t in _leaves(pool):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device) / 2)
        else:
            t.copy_(torch.randint(0, 16, t.shape, generator=gen,
                                  device=t.device))


def paged_step_check(backend: str, layout: str, model) -> dict:
    """Phase 16b, one run: ``launch.steps.make_paged_decode_step`` (its
    arguments on ``meta``, shapes only; the served model's weights and run
    context in) on a pool of ``PAGED_SLOTS`` + ``PAGED_LANES`` random pages
    of ``PAGED_PAGE`` positions, lanes on rows [1, 3, 5, scratch] at
    positions [192, 17, 255, 0], against the engine's own step
    (``serving.engine._decode_step`` / ``_legacy_decode_step``) on a copy
    of the pool: next ids and every pool leaf bitwise, and the step's
    launches by route the formula's (``PERF.md`` §3: C or A 6L + 1, plus D
    or B L on ``fused``). One call of each timed after a warm one
    (``paged step``)."""
    from repro_torch import configs as C
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.serving import engine as eng_mod

    from repro_torch.layers.backends import cim_config

    cfg, params, ctx = model
    dev = next(_leaves(params)).device
    quant = {"mxfp4": "mxfp4_wonly", "cim": "cim"}[backend]
    shape = C.Shape(PAGED_PAGE, PAGED_LANES, "decode")
    bundle = steps_mod.make_paged_decode_step(
        cfg, make_local_mesh(1, 1, device="meta"), shape, PAGED_SLOTS,
        quant=quant, kv_layout=layout, device="meta")
    fused = layout == "fused"
    mx = bundle.ctx.hybrid_digital_sdpa
    pool = lm.init_cache(cfg, PAGED_SLOTS + PAGED_LANES, PAGED_PAGE,
                         mx_digital=mx, fused=fused, device=dev)
    _random_pool(pool, torch.Generator(dev).manual_seed(4))
    copy = [[{k: v.clone() for k, v in layer.items()} for layer in seg]
            for seg in pool]
    specs = lm.cache_specs(cfg, mx_digital=mx, fused=fused)
    rows = torch.tensor([1, 3, 5, PAGED_SLOTS + 3], dtype=torch.int32,
                        device=dev)
    ids = torch.tensor([[11], [7000], [123], [5]], dtype=torch.int32,
                       device=dev) % cfg.vocab_size
    pos = torch.tensor([PAGED_PAGE * 3 // 4, 17, PAGED_PAGE - 1, 0],
                       dtype=torch.int32, device=dev) % PAGED_PAGE
    # the bundle's own context, as the engine's (its obs and cim config)
    fn_ctx = dataclasses.replace(ctx, obs=None)
    if (fn_ctx.quant, cim_config(fn_ctx)) != (bundle.ctx.quant,
                                              cim_config(bundle.ctx)):
        raise AssertionError(f"paged step: the model runs {fn_ctx.quant} "
                             f"({cim_config(fn_ctx)}), the bundle "
                             f"{bundle.ctx.quant}")
    _zero_counts()
    got, pool = bundle.fn(params, pool, rows, ids, pos)
    torch.cuda.synchronize()
    launches, mm_routes = _read_counts()
    cim_routes = _cim_routes()
    step_in = torch.stack([rows, ids[:, 0], pos]).long()
    if fused:
        want = eng_mod._decode_step(params, cfg, fn_ctx, copy, step_in)
    else:
        want = eng_mod._legacy_decode_step(params, cfg, fn_ctx, copy, specs,
                                           step_in)
    ids_equal = torch.equal(got.long(), want)
    pool_equal = all(torch.equal(a, b) for a, b in zip(_leaves(pool),
                                                       _leaves(copy)))
    ms = _time_ms(lambda: bundle.fn(params, pool, rows, ids, pos), 5)
    n = cfg.n_layers
    lin = "cim_linear" if backend == "cim" else "mxfp4_matmul"
    att = "paged_decode_mx" if backend == "cim" else "paged_decode"
    formula = {k: 0 for k in launches}
    formula[lin] = 6 * n + 1
    if fused:
        formula[att] = n
    out = dict(backend=backend, layout=layout, layers=n, lanes=PAGED_LANES,
               slots=PAGED_SLOTS, page=PAGED_PAGE, ids=got.tolist(),
               ids_equal=ids_equal, pool_bitwise=pool_equal,
               launches=launches, formula=formula,
               mxfp4_matmul_routes=mm_routes, cim_linear_routes=cim_routes,
               step_ms=ms)
    print(f"paged step {json.dumps(out)}", flush=True)
    if not (ids_equal and pool_equal):
        raise AssertionError(f"paged step {backend} {layout}: ids equal "
                             f"{ids_equal}, pool bitwise {pool_equal}")
    if launches != formula:
        raise AssertionError(f"paged step {backend} {layout}: launches "
                             f"{launches}, formula {formula}")
    return out


def paged_steps() -> dict:
    """Phase 16b: each of ``PAGED_RUNS`` (:func:`paged_step_check`), the
    model of a backend built once by the launcher's ``build_model``."""
    from repro_torch.launch import serve

    out = {}
    for backend in dict.fromkeys(b for b, _ in PAGED_RUNS):
        t0 = time.perf_counter()
        cfg, params, ctx, _ = serve.build_model(
            serve.build_parser().parse_args(PAGED_ARGS[backend]))
        build_s = time.perf_counter() - t0
        for b, layout in PAGED_RUNS:
            if b == backend:
                out[f"{backend} {layout}"] = dict(paged_step_check(
                    backend, layout, (cfg, params, ctx)), build_s=build_s)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _zero_counts() -> None:
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops

    for fn in _kernel_wrappers().values():
        fn.launches = 0
    for r in mm_ops.ROUTES:
        mm_ops.mxfp4_matmul.route_launches[r] = 0
    for r in cim_ops.ROUTES:
        cim_ops.cim_linear.route_launches[r] = 0
    for r in fa_ops.ROUTES:
        fa_ops.flash_attention.route_launches[r] = 0
    mm_ops.mxfp4_matmul.f32_launches = 0
    cim_ops.cim_linear.sums_launches = 0
    for fn in (pops.paged_flash_decode, pops.paged_flash_decode_mx):
        fn.partial_launches = 0


def _read_counts() -> tuple[dict, dict]:
    """(launches by kernel, ``mxfp4_matmul`` launches by route)."""
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops

    return ({name: fn.launches for name, fn in _kernel_wrappers().items()},
            dict(mm_ops.mxfp4_matmul.route_launches))


def _mode_counts() -> dict:
    """The sharded steps' kernel modes' launches since the counts were
    zeroed: C with f32 out, A's pass sums (the row-parallel linears), D's
    and B's partial (o, lse) (the fused decode over ranks)."""
    from repro_torch.kernels.cim_linear import ops as cim_ops
    from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pops

    return {"mxfp4_matmul f32": mm_ops.mxfp4_matmul.f32_launches,
            "cim_linear sums": cim_ops.cim_linear.sums_launches,
            "paged_decode partial": pops.paged_flash_decode.partial_launches,
            "paged_decode_mx partial":
                pops.paged_flash_decode_mx.partial_launches}


def _cim_routes() -> dict:
    """``cim_linear`` launches by route since the counts were zeroed."""
    from repro_torch.kernels.cim_linear import ops as cim_ops

    return dict(cim_ops.cim_linear.route_launches)


def _engine(params, cfg, ctx, prefill_len: int = M_PREFILL,
            page_len: int = 256, cuda_graphs: bool = True,
            kv_layout: str = "fused"):
    from repro_torch.serving import Engine, EngineConfig

    return Engine(params, cfg, dataclasses.replace(ctx, obs=None),
                  EngineConfig(lanes=4, num_slots=4, page_len=page_len,
                               prefill_len=prefill_len, kv_layout=kv_layout,
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
                   page_len: int = 256, attempts: int = PROFILE_ATTEMPTS,
                   kv_layout: str = "fused") -> dict:
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
    ``wall_ms``, ``busy_share``, ``tok_s``). ``kv_layout`` picks the
    engine's pool (``legacy``: the gather, decode and scatter step)."""
    out, tokens = {}, {}
    for mode in ("eager", "captured"):
        eng = _engine(params, cfg, ctx, max(M_PREFILL, prompt_len), page_len,
                      cuda_graphs=mode == "captured", kv_layout=kv_layout)
        rng = np.random.default_rng(5)
        for _ in range(4):
            eng.add_request(
                rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                max_new=(attempts + 1) * steps + 4)
        while len(eng.sched.running) < 4:  # the four prefills
            eng.step()
        eng.step()  # one decode step outside the window
        prof = _profiled(f"decode profile {kv_layout} {mode}"
                         if kv_layout != "fused" else f"decode profile {mode}",
                         ctx, steps, eng.step, attempts=attempts)
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
        {"backend": ctx.quant, "kv_layout": kv_layout,
         "tokens_compared": n * len(tokens["eager"]),
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
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # phase 14b's deterministic kill-restart needs cuBLAS's workspace fixed
    # before the first cuBLAS call (32 MiB, as 8 x 4 MiB chunks); the
    # variable goes back to what it was after that phase
    cublas_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
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
    phase("fidelity linears", check_fidelity_linears, dev)  # phase 10
    for arch, backend in FID_RUNS:
        runs[f"fidelity {arch} {backend}"] = phase(
            f"fidelity {arch} [{backend}]", fidelity_model, arch, backend)
    moe_rows = phase("moe kernels", check_moe_kernels, dev)  # phase 11
    for arch, backend in MOE_RUNS:
        runs[f"moe {arch} {backend}"] = phase(
            f"serve {arch} [{backend}]", serve_moe_vlm, arch, backend)
    rec_rows = phase("recurrent kernels", check_recurrent_kernels,
                     dev)  # phase 12
    for arch, backend in REC_RUNS:
        runs[f"rec {arch} {backend}"] = phase(
            f"serve {arch} [{backend}]", serve_recurrent, arch, backend,
            REC_BATCH, REC_PROMPT, REC_TOKENS, True,
            REC_LAYERS.get((arch, backend), 0))
    runs["rec zamba2-1.2b long"] = phase(
        "serve zamba2-1.2b long [mxfp4]", serve_recurrent, "zamba2-1.2b",
        "mxfp4", 1, REC_LONG_PROMPT, REC_LONG_TOKENS, False)
    for backend in ("mxfp4", "cim"):
        runs[f"rec hubert-xlarge {backend}"] = phase(
            f"encode hubert-xlarge [{backend}]", encode_audio, backend)
    # phase 13: the stage-parallel pipeline, every grid place on this card
    runs["pipeline vit-l32 cim"] = phase("pipeline vit-l32 [cim]",
                                         pipeline_vit)
    runs["pipeline vit-b16 mxfp4"] = phase("pipeline router vit-b16 [mxfp4]",
                                           pipeline_router)
    runs["pipeline starcoder2-7b cim"] = phase(
        "pipeline starcoder2-7b [cim]", pipeline_lm)
    # phase 14: training (no kernel launches; not in the kernels line)
    phase("train full width", train_full_width, dev)
    phase("train launcher", train_launcher, dev)
    if cublas_ws is None:
        del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas_ws
    phase("train tiny", train_tiny_agreement, dev)
    phase("dry run", dry_run, dev, smi)  # phase 15
    # phase 16: the sharded train step (NCCL, one rank) and the paged step
    phase("train sharded", train_sharded_nccl, dev, smi)
    phase("paged steps", paged_steps)
    # phase 17: the row-parallel kernel modes, the sharded serving steps
    c_f32 = phase("c f32 out", check_c_f32_out, dev)
    a_sums = phase("a pass sums", check_a_sums, dev)
    partial = phase("decode partial", check_decode_partial, dev)
    sharded_runs = phase("sharded serve", serve_sharded, dev, smi)
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
    kernels += moe_kernel_entries(moe_rows, runs)
    kernels += recurrent_kernel_entries(rec_rows, runs)
    kernels += rowpar_kernel_entries(c_f32, a_sums, partial, sharded_runs)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
