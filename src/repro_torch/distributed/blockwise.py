"""Block-level cost analysis of a cell and per-layer serving costs
(counterpart of the reference's ``repro.distributed.blockwise``).

:func:`analyze_cell` counts a step's work on the ``meta`` device with the
port's counter (``obs.cost``): no compile, no allocation. It composes the
step as the reference does, from one block a distinct segment signature
times its trip counts:

  train:   sum_seg n_seg * (fwd+bwd block cost) * k_micro
           + (stem + head & loss & grads) * k_micro + optimizer
           + the step-boundary weight fake-quant (prequant)
  serve:   sum_seg n_seg * fwd block cost + stem + head

The counter runs the port's own eager ops, so it counts what the port
runs: the backward with no rematerialisation (the port keeps its
activations), the kernels' calls with their ``cost()`` models, every trip
of a Python loop. Each block runs the dense attention path
(``dense_attn_max`` unbounded: exact quadratic FLOPs, as the reference).
A block whose sequence is longer than ``DENSE_MAX`` is fitted with the
reference's two-point model a*S + b*S^2 at S0 and 2*S0. An sLSTM block is
linear in S (its recurrence steps one token at a time), so it is counted
at ``SLSTM_S`` and 2 ``SLSTM_S`` tokens and extended linearly: the
reference's block + (S - 1) cells, exact, without S Python steps.

The counts are global (the whole batch, unsplit weights); the per-device
figures are global / n_devices, an ideal split (``per_device``
``"ideal"``): the port runs no GSPMD program, so no collective is read
and ``t_collective_s`` is None.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ViTConfig
from repro_torch.distributed import roofline as rl
from repro_torch.layers.common import (
    RunCtx,
    convert_params_mxfp4,
    quantize_weights_tree,
)
from repro_torch.models import lm
from repro_torch.models import vit as vit_mod
from repro_torch.obs.cost import CostCounter
from repro_torch.optim import adamw

DENSE_MAX = 4096  # the longest sequence a block is counted at directly
SLSTM_S = 64  # an sLSTM block's first count point (linear in S)
_META = torch.device("meta")


def _count(fn, *args) -> dict:
    with CostCounter() as c:
        fn(*args)
    return {"flops": c.flops, "bytes": c.bytes}


def _zero() -> dict:
    return {"flops": 0.0, "bytes": 0.0}


def _acc(tot: dict, c: dict, mult: float = 1.0) -> dict:
    for k in tot:
        tot[k] += c[k] * mult
    return tot


def _sig(seg):
    return (seg.kind, seg.attn, seg.mamba, seg.xl)


def _serve_tree(params, quant: str):
    """A meta tree as the step holds it: packed under ``mxfp4_wonly``,
    quantized at the step boundary under the prequant backend."""
    if quant == "mxfp4_wonly":
        return convert_params_mxfp4(params)
    if quant == "mxfp4_ste_prequant":
        return quantize_weights_tree(
            params, adamw.tree_map(params, lambda t: t.ndim))
    return params


def _grad_run(out, params, x):
    """Backward of ``out`` into ``params``' leaves and ``x`` (a cotangent
    of ones), as a train step's gradient pass."""
    flat = [t for t in adamw.leaves(params) if t.requires_grad] + [x]
    torch.autograd.grad(out, flat, grad_outputs=torch.ones_like(out),
                        allow_unused=True)


def _block(cfg, seg, quant: str):
    """One layer's meta parameters (the Zamba shared block's for a
    ``zshared`` visit) as the step holds them."""
    gen = torch.Generator()
    p = (lm.zshared_init(gen, cfg, _META) if seg.kind == "zshared"
         else lm.block_init(gen, cfg, seg, _META))
    return _serve_tree(p, quant)


def _block_cost(cfg, seg, ctx, p, b: int, s: int, grad: bool) -> dict:
    """One block over [b, s] tokens: forward, or forward and backward."""
    def run():
        x = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                        device=_META)
        pos = torch.arange(s, device=_META)[None].expand(b, s)
        with torch.set_grad_enabled(grad):
            if grad:
                x.requires_grad_(True)
                for t in adamw.leaves(p):
                    if t.is_floating_point():
                        t.requires_grad_(True)
            shared = p if seg.kind == "zshared" else None
            layers = [{}] if seg.kind == "zshared" else [p]
            y, _ = lm.run_segment(ctx, cfg, seg, layers, x, pos,
                                  path="segments/0", shared=shared, x0=x)
            if grad:
                _grad_run(y, p, x)

    return _count(run)


def _decode_cost(cfg, seg, ctx, p, batch: int, seq: int) -> dict:
    """One block's decode step of ``batch`` lanes at position ``seq`` - 1
    over a fresh legacy cache of ``seq``."""
    def run():
        cache = lm._block_cache(seg, batch, seq, False, False, _META)
        x = torch.empty((batch, 1, cfg.d_model), dtype=torch.bfloat16,
                        device=_META)
        pos = torch.full((batch, 1), seq - 1, device=_META)
        shared = p if seg.kind == "zshared" else None
        layers = [{}] if seg.kind == "zshared" else [p]
        with torch.no_grad():
            lm.run_segment(ctx, cfg, seg, layers, x, pos, [cache], seq - 1,
                           path="segments/0", shared=shared, x0=x)

    return _count(run)


def _fit(cost_at, s: int, s0: int, degree: int) -> dict:
    """The cost at ``s`` from two counts at ``s0`` and ``2 s0``: the
    reference's a*S + b*S^2 (``degree`` 2), or a + b*S (1)."""
    c1, c2 = cost_at(s0), cost_at(2 * s0)
    out = {}
    for k in c1:
        if degree == 2:
            bq = (c2[k] - 2 * c1[k]) / (2 * s0 * s0)
            aq = (c1[k] - bq * s0 * s0) / s0
            out[k] = max(aq * s + bq * s * s, 0.0)
        else:
            slope = (c2[k] - c1[k]) / s0
            out[k] = max(c1[k] + slope * (s - s0), 0.0)
    return out


def _trunkless(cfg):
    """The model's meta parameters with no layers: embedding, front end,
    final norm and head (the stem and head of a step)."""
    params = lm.init_model(cfg, torch.Generator(), device=_META)
    params["segments"] = [[] for _ in params["segments"]]
    params.pop("shared", None)
    return params


def _stem_head_cost(cfg, shape, quant: str, b: int, is_train: bool) -> dict:
    """The stem and head of one microbatch (train: with the chunked loss
    and its gradients) or of the serving step (prefill: the head on the
    last position, as ``launch.steps``; decode: one token a lane through
    ``lm.decode_step``)."""
    from repro_torch import configs as C
    from repro_torch.launch import steps as steps_mod
    from repro_torch.runtime.trainer import loss_and_grads

    params = _trunkless(cfg)
    ctx = RunCtx(quant=quant, dense_attn_max=1 << 30)
    if is_train:
        batch = C.input_specs(cfg, C.Shape(shape.seq, b, "train"))

        def run():
            q = _serve_tree(params, quant)
            loss_and_grads(q, cfg, ctx, batch)

        return _count(run)
    q = _serve_tree(params, quant)
    batch = C.input_specs(cfg, shape)

    @torch.no_grad()
    def run():
        if shape.kind == "decode":
            empty = [[] for _ in q["segments"]]
            logits, _ = lm.decode_step(q, cfg, ctx, batch["ids"], 0, empty)
        else:
            hidden, _ = lm.forward(q, cfg, ctx, batch, return_hidden=True)
            logits = steps_mod._head_logits(cfg, q, hidden[:, -1])
        torch.argmax(logits.to(torch.float32), dim=-1)

    return _count(run)


def analyze_cell(cfg, shape, mesh, quant: str | None = None,
                 fsdp: bool = True, k_micro: int | None = None) -> dict:
    """Per-device roofline totals of one cell (the reference's keys; see
    the module docstring). ``fsdp`` is kept for the reference's signature:
    a count of work does not depend on where parameters are stored."""
    from repro_torch.launch import steps as steps_mod

    del fsdp
    n_dev = mesh.size
    is_train = shape.kind == "train"
    quant = quant or ("mxfp4_ste_prequant" if is_train else "mxfp4_wonly")
    if quant == "mxfp4_ste":
        quant = "mxfp4_ste_prequant"  # what the train step runs
    ctx = RunCtx(quant=quant, dense_attn_max=1 << 30, arange_positions=True)
    if k_micro is None:
        k_micro = steps_mod.pick_microbatches(mesh, shape) if is_train else 1
    b = shape.batch // k_micro

    counts: dict = {}
    rep: dict = {}
    for seg in lm.build_segments(cfg):
        key = _sig(seg)
        counts[key] = counts.get(key, 0) + seg.n
        rep[key] = seg

    total = _zero()
    details = {}
    for key, seg in rep.items():
        n = counts[key]
        p = _block(cfg, seg, quant)
        if shape.kind == "decode":
            c = _decode_cost(cfg, seg, ctx, p, shape.batch, shape.seq)
        else:
            def at(s, seg=seg, p=p):
                return _block_cost(cfg, seg, ctx, p, b, s, is_train)

            if seg.kind == "slstm" and shape.seq > 2 * SLSTM_S:
                c = _fit(at, shape.seq, SLSTM_S, 1)
            elif shape.seq <= DENSE_MAX:
                c = at(shape.seq)
            else:
                c = _fit(at, shape.seq, DENSE_MAX // 2, 2)
        mult = n * (k_micro if is_train else 1)
        _acc(total, c, mult)
        details[f"{key[0]}_n{n}"] = {**c, "mult": mult}

    stem_head = _stem_head_cost(cfg, shape, quant, b, is_train)
    _acc(total, stem_head, mult=k_micro if is_train else 1)
    details["stem_head"] = stem_head

    if is_train:
        params, _ = steps_mod.param_structs(cfg)
        state = adamw.init(params)
        optc = _count(lambda: adamw.apply(
            adamw.AdamWConfig(), params, adamw.tree_map(params, torch.empty_like),
            state, lm.ref_ndim_tree(cfg, params)))
        _acc(total, optc)
        details["optimizer"] = optc
        if quant == "mxfp4_ste_prequant":
            wq = _count(lambda: quantize_weights_tree(
                params, lm.ref_ndim_tree(cfg, params)))
            _acc(total, wq)
            details["weight_quant"] = wq

    terms = rl.roofline_terms(
        {"flops": total["flops"] / n_dev,
         "bytes accessed": total["bytes"] / n_dev}, None, n_dev)
    terms["per_device"] = "ideal"  # global / n_devices
    terms["k_micro"] = k_micro
    terms["details"] = details
    return terms


def serve_layer_costs(cfg, n_tokens: int) -> list[float]:
    """Closed-form forward FLOPs of each layer for serving-time stage
    balancing (``sharding.stage_partition(mode="balanced")``): the static
    linears' matmul FLOPs plus the quadratic (window-clipped) SDPA term.
    Stage cuts need only the layers' relative weights. Non-attention block
    kinds get projection-dominated estimates; they cannot ride the stage
    pipeline (``distributed.pipeline_exec``) but keep the cost vector
    aligned with the layer index."""
    segs = (vit_mod.build_segments(cfg) if isinstance(cfg, ViTConfig)
            else lm.build_segments(cfg))
    N = int(n_tokens)
    d = cfg.d_model
    glu = cfg.ffn_kind in ("swiglu", "geglu")
    costs: list[float] = []
    for seg in segs:
        for _ in range(seg.n):
            if seg.kind in ("attn", "moe_attn", "zshared"):
                a = seg.attn
                proj = 2 * N * d * a.n_heads * a.head_dim * 2  # q + o
                proj += 2 * N * d * a.n_kv * a.head_dim * 2  # k + v
                eff = min(N, a.window) if a.window else N
                sdpa = 4 * N * eff * a.n_heads * a.head_dim  # qk^T + pv
                n_mats = 3 if glu else 2
                ffn = 2 * N * n_mats * d * cfg.d_ff
                if seg.kind == "moe_attn":
                    ffn *= max(cfg.top_k, 1)
                if seg.kind == "zshared":
                    proj += 2 * N * (2 * d) * d + 2 * N * d * d  # w_in, w_out
                costs.append(float(proj + sdpa + ffn))
            elif seg.kind == "mamba":
                m = seg.mamba
                inner = m.n_heads * m.head_dim
                proj = 2 * N * d * (2 * inner + 2 * m.n_heads * m.d_state)
                proj += 2 * N * inner * d  # out projection
                scan = 4 * N * m.n_heads * m.head_dim * m.d_state
                costs.append(float(proj + scan))
            elif seg.kind in ("mlstm", "slstm"):
                # qkv / gate and out projections dominate the recurrent cell
                costs.append(float(2 * N * d * 4 * d + 2 * N * 2 * d * d))
            else:
                raise ValueError(seg.kind)
    return costs
