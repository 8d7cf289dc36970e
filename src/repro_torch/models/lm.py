"""Decoder LM over segments of identical blocks (counterpart of
``repro.models.lm``): attention + FFN blocks (``attn``) and attention +
MoE blocks (``moe_attn``: mixtral-8x22b, qwen3-moe-235b-a22b) under full
attention (starcoder2-7b), a sliding window (h2o-danube-1.8b, mixtral)
or runs of local and global layers (gemma3-1b's 5:1 pattern, one segment
a run), with RoPE or M-RoPE (qwen2-vl-7b, whose vision front end is the
reference's stub: ``front_proj`` on precomputed patch embeddings); the
recurrent families: xLSTM (``mlstm`` / ``slstm`` runs, xlstm-125m) and
the Zamba hybrid (``mamba`` runs, each followed by a visit of the shared
attention block, ``zshared``, whose weights sit once under the top-level
``shared``: zamba2-1.2b); and the encoder-only audio family
(hubert-xlarge: non-causal, no RoPE, the reference's front-end stub of
``front_proj`` on frame embeddings plus sinusoidal positions).

The layer stack runs as a Python loop over unstacked layers: the
reference's ``unroll_layers=True`` mode, the one in which it pins bitwise
MXFP4 identity. Parameters keep the reference's tree (``embed``,
``segments``, ``shared``, ``final_ln``, ``lm_head``) with one dict per
layer under ``segments[i]`` where the reference stacks a leading layer
axis (a ``zshared`` segment holds one empty dict). Caches are likewise
one dict per layer: a fused page or a legacy split K/V cache for the
attention kinds, conv tails and states for the recurrent ones.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import ffn as ffn_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.layers import rope as ropelib
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers import xlstm as xl_mod
from repro_torch.layers.backends import layer_paths
from repro_torch.layers.common import (
    EMBED_SPECS,
    RunCtx,
    embed_apply,
    embed_init,
    init_device,
    linear_apply,
    linear_init,
    linear_specs,
    norm_apply,
    norm_init,
    norm_specs,
)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # attn | moe_attn | mamba | mlstm | slstm | zshared
    n: int
    attn: attn_mod.AttnStatic | None = None
    mamba: ssm_mod.MambaStatic | None = None
    xl: xl_mod.XLSTMStatic | None = None


# segment kinds whose cache is K/V (a decode writes it in place); the
# others carry recurrent state (a decode returns new tensors)
ATTN_KINDS = ("attn", "moe_attn", "zshared")


def _attn_static(cfg: ArchConfig, is_global: bool = False
                 ) -> attn_mod.AttnStatic:
    """A layer's attention: ``cfg.window`` for sliding-window and local
    layers; a global layer of a local:global pattern attends to the whole
    page at ``rope_theta_global``."""
    window = 0
    if cfg.attn_pattern == "swa":
        window = cfg.window
    elif cfg.attn_pattern == "local_global":
        window = 0 if is_global else cfg.window
    return attn_mod.AttnStatic(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, causal=cfg.causal, window=window,
        rope_theta=cfg.rope_theta_global if is_global else cfg.rope_theta,
        use_rope=cfg.family != "audio", mrope=cfg.mrope,
        qk_norm=cfg.qk_norm, use_bias=cfg.use_bias, norm=cfg.norm,
    )


def _runs(kinds: list) -> list:
    """(kind, length) of each maximal run of equal kinds."""
    out, i = [], 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        out.append((kinds[i], j - i))
        i = j
    return out


def build_segments(cfg: ArchConfig) -> list[Segment]:
    """The reference's segments. Attention LMs (the dense, MoE, audio and
    vlm families): one segment of every layer, or, for ``local_global``,
    one a run of local or global layers (layer i is global when ``i %
    (lg_ratio + 1) == lg_ratio``; gemma3-1b's 26 layers are L5 G1 L5 G1
    L5 G1 L5 G1 L2); a config with experts gets ``moe_attn`` segments.
    xLSTM (``ssm``): a run of ``mlstm`` or ``slstm`` layers each
    (``slstm_at``). The Zamba hybrid: runs of ``shared_attn_every`` Mamba
    layers, each followed by a ``zshared`` visit, except after a shorter
    last run."""
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        kind = "moe_attn" if cfg.n_experts else "attn"
        if cfg.attn_pattern != "local_global":
            return [Segment(kind, cfg.n_layers, attn=_attn_static(cfg))]
        glob = [i % (cfg.lg_ratio + 1) == cfg.lg_ratio
                for i in range(cfg.n_layers)]
        return [Segment(kind, n, attn=_attn_static(cfg, is_global=g))
                for g, n in _runs(glob)]
    if cfg.family == "ssm":
        xl = xl_mod.XLSTMStatic(d_model=cfg.d_model, n_heads=cfg.n_heads,
                                norm=cfg.norm)
        kinds = ["slstm" if i in cfg.slstm_at else "mlstm"
                 for i in range(cfg.n_layers)]
        return [Segment(k, n, xl=xl) for k, n in _runs(kinds)]
    if cfg.family == "hybrid":
        mst = ssm_mod.MambaStatic(
            d_model=cfg.d_model, n_heads=2 * cfg.d_model // cfg.ssm_head_dim,
            head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state, norm=cfg.norm)
        segs: list[Segment] = []
        left, k = cfg.n_layers, cfg.shared_attn_every
        while left > 0:
            take = min(k, left)
            segs.append(Segment("mamba", take, mamba=mst))
            left -= take
            if left > 0 or take == k:
                segs.append(Segment("zshared", 1, attn=_attn_static(cfg)))
        return segs
    raise ValueError(cfg.family)


# ---------------------------------------------------------------- init

def init_model(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    """Random float32 parameters on ``device`` (default ``gen``'s). On
    ``meta`` they are shapes and dtypes only, from a CPU ``gen``: the
    dry-run's parameters (``launch.steps.param_structs``)."""
    dev = init_device(gen, device)
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        device=dev)}
    if cfg.frontend != "none":
        params["front_proj"] = linear_init(gen, cfg.frontend_dim, cfg.d_model,
                                           device=dev)
    segs = build_segments(cfg)
    params["segments"] = [[block_init(gen, cfg, seg, dev)
                           for _ in range(seg.n)] for seg in segs]
    if any(seg.kind == "zshared" for seg in segs):
        params["shared"] = zshared_init(gen, cfg, dev)
    params["final_ln"] = norm_init(cfg.norm, cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        device=dev)
    return params


def param_specs(cfg: ArchConfig) -> dict:
    """Logical axes of every leaf of :func:`init_model`'s tree: the
    reference's ``init_model`` specs laid out as the port's tree, one dict
    a layer (no leading ``layers`` axis: the reference's rule for it is
    None, so no shard and no ZeRO choice moves)."""
    specs: dict = {"embed": dict(EMBED_SPECS)}
    if cfg.frontend != "none":
        specs["front_proj"] = linear_specs()
    segs = build_segments(cfg)
    specs["segments"] = [[block_specs(cfg, seg) for _ in range(seg.n)]
                         for seg in segs]
    if any(seg.kind == "zshared" for seg in segs):
        specs["shared"] = zshared_specs(cfg)
    specs["final_ln"] = norm_specs(cfg.norm)
    if not cfg.tie_embeddings:
        specs["lm_head"] = linear_specs("embed", "vocab")
    return specs


def block_specs(cfg, seg: Segment) -> dict:
    """Logical axes of :func:`block_init`'s leaves."""
    if seg.kind == "mamba":
        return ssm_mod.mamba_specs(seg.mamba)
    if seg.kind == "mlstm":
        return xl_mod.mlstm_specs(seg.xl)
    if seg.kind == "slstm":
        return xl_mod.slstm_specs(seg.xl)
    if seg.kind == "zshared":
        return {}
    s = {"attn": attn_mod.attn_specs(seg.attn)}
    if seg.kind == "moe_attn":
        s["moe"] = moe_mod.moe_specs(cfg.ffn_kind, cfg.norm)
    else:
        s["ffn"] = ffn_mod.ffn_specs(cfg.ffn_kind, cfg.norm, cfg.use_bias)
    return s


def zshared_specs(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`zshared_init`'s leaves."""
    return {"w_in": linear_specs(),
            "attn": attn_mod.attn_specs(_attn_static(cfg)),
            "ffn": ffn_mod.ffn_specs(cfg.ffn_kind, cfg.norm),
            "w_out": linear_specs()}


def block_init(gen: torch.Generator, cfg, seg: Segment, device=None) -> dict:
    """One layer's parameters: a recurrent block (``mamba``, ``mlstm``,
    ``slstm``), nothing for a ``zshared`` visit (its weights are the
    top-level ``shared``), or the attention sublayer, then the FFN or, in
    a ``moe_attn`` segment, the MoE (``cfg`` needs ``d_model``, ``d_ff``,
    ``ffn_kind``, ``norm`` and ``use_bias``, and ``n_experts`` for MoE: an
    ``ArchConfig`` or a ``ViTConfig``)."""
    if seg.kind == "mamba":
        return ssm_mod.mamba_init(gen, seg.mamba, device)
    if seg.kind == "mlstm":
        return xl_mod.mlstm_init(gen, seg.xl, device)
    if seg.kind == "slstm":
        return xl_mod.slstm_init(gen, seg.xl, device)
    if seg.kind == "zshared":
        return {}
    p = {"attn": attn_mod.attn_init(gen, seg.attn, device)}
    if seg.kind == "moe_attn":
        p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, cfg.ffn_kind, cfg.norm,
                                    device)
    else:
        p["ffn"] = ffn_mod.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                    cfg.norm, cfg.use_bias, device)
    return p


def zshared_init(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """The Zamba shared block, once for all its visits: ``w_in`` [2d, d]
    over ``concat[x, x0]``, attention, the FFN and ``w_out`` [d, d]."""
    d = cfg.d_model
    return {"w_in": linear_init(gen, 2 * d, d, device=device),
            "attn": attn_mod.attn_init(gen, _attn_static(cfg), device),
            "ffn": ffn_mod.ffn_init(gen, d, cfg.d_ff, cfg.ffn_kind, cfg.norm,
                                    device=device),
            "w_out": linear_init(gen, d, d, device=device)}


# --------------------------------------------------------------- caches

def _block_cache(seg: Segment, batch: int, max_len: int, mx_digital: bool,
                 fused: bool, device) -> dict:
    if seg.kind in ATTN_KINDS:
        return attn_mod.attn_cache_init(seg.attn, batch, max_len,
                                        mx_digital=mx_digital, fused=fused,
                                        device=device)
    if seg.kind == "mamba":
        return ssm_mod.mamba_cache_init(seg.mamba, batch, device)
    if seg.kind == "mlstm":
        return xl_mod.mlstm_cache_init(seg.xl, batch, device)
    if seg.kind == "slstm":
        return xl_mod.slstm_cache_init(seg.xl, batch, device)
    raise ValueError(seg.kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               mx_digital: bool = False, fused: bool = False,
               device=None) -> list:
    """Decode caches, per segment one dict per layer, on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"`` is
    given): for the attention kinds a fused page (``fused``) or the legacy
    split K/V cache, with the quantized-resident mirrors under
    ``mx_digital``; for the recurrent kinds their conv tails and
    states."""
    return [[_block_cache(seg, batch, max_len, mx_digital, fused, device)
             for _ in range(seg.n)]
            for seg in build_segments(cfg)]


def _block_cache_specs(seg: Segment, mx_digital: bool, fused: bool) -> dict:
    if seg.kind in ATTN_KINDS:
        return attn_mod.attn_cache_specs(mx_digital, fused=fused)
    return {"mamba": ssm_mod.MAMBA_CACHE_SPECS,
            "mlstm": xl_mod.MLSTM_CACHE_SPECS,
            "slstm": xl_mod.SLSTM_CACHE_SPECS}[seg.kind]


def cache_specs(cfg: ArchConfig, mx_digital: bool = False,
                fused: bool = False) -> list:
    """Logical axes of each cache leaf, per segment (shared by its
    layers; no stacked layer axis)."""
    return [dict(_block_cache_specs(seg, mx_digital, fused))
            for seg in build_segments(cfg)]


# -------------------------------------------------------------- forward

def forward(params, cfg: ArchConfig, ctx: RunCtx, batch: dict, caches=None,
            pos=None, return_hidden: bool = False):
    """batch: {'ids' | 'emb', optional 'positions', optional 'vis_emb'}.
    Returns
    (logits or hidden, caches). ``pos`` (decode): int or int [B], the
    position of the token; with ``positions`` and caches, the start of a
    prefill chunk. Without either, row i sits at position i and
    ``ctx.arange_positions`` is set for the layers."""
    x = embed_inputs(ctx, cfg, params, batch)
    b, s, _ = x.shape
    if "positions" in batch:
        positions = batch["positions"]
    elif pos is not None:
        positions = torch.as_tensor(pos, device=x.device).reshape(-1, 1)
        positions = positions.expand(b, s)
    else:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        ctx = dataclasses.replace(ctx, arange_positions=True)
    x0 = x  # the Zamba shared block reads the embeddings again
    new_caches = []
    for i, seg in enumerate(build_segments(cfg)):
        x, seg_caches = run_segment(
            ctx, cfg, seg, params["segments"][i], x, positions,
            caches[i] if caches is not None else None, pos,
            path=f"segments/{i}", shared=params.get("shared"), x0=x0)
        new_caches.append(seg_caches)
    x = norm_apply(cfg.norm, params["final_ln"], x)
    if return_hidden:
        return x, new_caches
    return _head(ctx, cfg, params, x), new_caches


def run_segment(ctx: RunCtx, cfg, seg: Segment, layers: list, x, positions,
                caches: list | None = None, pos=None, *, path: str,
                shared: dict | None = None, x0=None,
                paths: list | None = None):
    """Run one segment's layers over ``x``: the counterpart of the
    reference's ``lm._run_segment`` in its unrolled mode. An attention
    layer is attention, then the FFN, each pre-norm with its residual
    (``cfg`` needs ``ffn_kind`` and ``norm``: an ``ArchConfig`` or a
    ``ViTConfig``; and ``top_k`` and ``capacity_factor`` for a
    ``moe_attn`` segment, whose MoE runs under the capture scope ``moe``).
    A recurrent layer is its block; a ``zshared`` visit runs the
    ``shared`` block on ``concat[x, x0]`` (``x0``: the embeddings) with
    its residual. Each layer's capture scope is ``<path>/L<j>``, or
    ``<path>`` for a single layer (``layers/backends.py::layer_paths``),
    unless ``paths`` names them (a pipeline stage's slice of a segment
    keeps the whole segment's paths); a
    ``zshared`` visit's is ``shared`` (its weights live there, so every
    visit records under the same paths, as in the reference). Returns (x,
    the layers' new caches, None each without ``caches``)."""
    a = seg.attn
    tables = (ropelib.rope_tables(positions, a.head_dim, a.rope_theta)
              if a is not None and a.use_rope and not a.mrope else None)
    new_caches = []
    if paths is None:
        paths = layer_paths(path, len(layers))
    for j, (pj, lpath) in enumerate(zip(layers, paths)):
        lctx = ctx.scoped(lpath)
        cj = caches[j] if caches is not None else None
        if seg.kind == "mamba":
            x, nc = ssm_mod.mamba_apply(lctx, seg.mamba, pj, x, cj)
        elif seg.kind == "mlstm":
            x, nc = xl_mod.mlstm_apply(lctx, seg.xl, pj, x, cj)
        elif seg.kind == "slstm":
            x, nc = xl_mod.slstm_apply(lctx, seg.xl, pj, x, cj)
        elif seg.kind == "zshared":
            x, nc = _zshared_apply(ctx, cfg, a, shared, x, x0, positions, cj,
                                   pos, tables)
        else:
            x, nc = attn_mod.attn_apply(lctx.scoped("attn"), a, pj["attn"],
                                        x, positions, cj, pos,
                                        rope_tables=tables)
            if seg.kind == "moe_attn":
                x = moe_mod.moe_apply(lctx.scoped("moe"), cfg.ffn_kind,
                                      cfg.norm, pj["moe"], x, cfg.top_k,
                                      cfg.capacity_factor)
            else:
                x = ffn_mod.ffn_apply(lctx.scoped("ffn"), cfg.ffn_kind,
                                      cfg.norm, pj["ffn"], x)
        new_caches.append(nc)
    return x, new_caches


def _zshared_apply(ctx, cfg, a, shared, x, x0, positions, cache, pos,
                   tables):
    """One visit of the Zamba shared block. Under a tap or a fidelity
    probe the capture scope is reset to ``shared`` (not appended)."""
    sctx = (ctx if ctx.tap is None and ctx.fidelity is None
            else dataclasses.replace(ctx, scope="shared"))
    h = linear_apply(sctx, shared["w_in"], torch.cat([x, x0], dim=-1),
                     name="w_in")
    h, nc = attn_mod.attn_apply(sctx.scoped("attn"), a, shared["attn"], h,
                                positions, cache, pos, rope_tables=tables)
    h = ffn_mod.ffn_apply(sctx.scoped("ffn"), cfg.ffn_kind, cfg.norm,
                          shared["ffn"], h)
    y = linear_apply(sctx, shared["w_out"], h, name="w_out")
    return x + y.to(x.dtype), nc


def _sinusoid_table(s: int, dim: int, device) -> torch.Tensor:
    """The audio stub's sinusoidal positions [s, dim] in f32, as the
    reference computes them: ``inv = 1 / 10000 ** (arange(0, dim, 2) /
    dim)``, then ``[sin(pos * inv), cos(pos * inv)]``."""
    pos = torch.arange(s, dtype=torch.int32, device=device)
    ex = torch.arange(0, dim, 2, dtype=torch.int32, device=device) / dim
    inv = 1.0 / torch.pow(torch.tensor(10000.0, device=device), ex)
    ang = pos[:, None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_inputs(ctx: RunCtx, cfg: ArchConfig, params, batch: dict):
    """Token embeddings (bf16); for the vision front end with
    ``batch["vis_emb"]`` [B, nv, frontend_dim], ``front_proj`` of the patch
    embeddings replaces the first ``nv`` token embeddings (the reference's
    stub). The audio front end (the reference's stub) takes
    ``batch["emb"]`` [B, S, frontend_dim] through ``front_proj`` and adds
    the sinusoidal positions (f32, cast to the projection's dtype), in
    bf16."""
    if cfg.frontend == "audio":
        x = linear_apply(ctx, params["front_proj"], batch["emb"],
                         name="front_proj")
        pe = _sinusoid_table(x.shape[1], cfg.d_model, x.device)
        return (x + pe[None].to(x.dtype)).to(torch.bfloat16)
    x = embed_apply(params["embed"], batch["ids"])
    if cfg.frontend == "vision" and "vis_emb" in batch:
        v = linear_apply(ctx, params["front_proj"], batch["vis_emb"],
                         name="front_proj")
        x = torch.cat([v.to(x.dtype), x[:, v.shape[1]:]], dim=1)
    return x


def _head(ctx, cfg, params, x):
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"]["emb"].to(torch.bfloat16).T)
    return linear_apply(ctx, params["lm_head"], x, name="lm_head")


def lm_loss(params, cfg: ArchConfig, ctx: RunCtx, batch: dict,
            chunk: int = 1024) -> torch.Tensor:
    """Mean cross-entropy over the labeled tokens (``batch["labels"]``,
    weighted by ``batch["loss_mask"]`` where given), the reference's
    ``lm_loss``: the head runs on sequence chunks of ``chunk`` rows (the
    sequence zero-padded to a whole number of chunks, the pad masked out),
    so no [B, S, V] f32 logits are ever whole. Per chunk: f32 logits,
    ``logsumexp`` and the gold logit, summed under the mask; the total
    over ``max(count, 1)``. Differentiable through every family."""
    hidden, _ = forward(params, cfg, ctx, batch, return_hidden=True)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    s = hidden.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tots, cnts = [], []
    for c in range(0, s + pad, chunk):
        m = mask[:, c:c + chunk]
        logits = _head(ctx, cfg, params, hidden[:, c:c + chunk]).to(
            torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c:c + chunk, None])[..., 0]
        tots.append(((lse - gold) * m).sum())
        cnts.append(m.sum())
    return torch.stack(tots).sum() / torch.clamp(torch.stack(cnts).sum(),
                                                 min=1.0)


def ref_ndim_tree(cfg: ArchConfig, tree) -> dict:
    """Each leaf's ndim in the reference's tree, as a tree of ints of the
    same structure as ``tree`` (parameters, or gradients and optimizer
    moments of the same layout). The reference stacks a segment's layers
    into leaves with a leading layer axis only when the segment has more
    than one layer (``repro.models.lm.init_model``); the port keeps one
    dict per layer. So a leaf of a segment of n > 1 layers has one dim
    more there. The training rules that read ndim (the prequant of
    ``layers.common.quantize_weights_tree``, the weight decay of
    ``optim.adamw.apply``) take it from here: a norm gamma, a bias or a
    Mamba ``A_log`` is decayed and cast to bf16 inside a stacked segment
    and not in a single-layer one."""
    def nd(node, extra: int):
        if isinstance(node, dict):
            return {k: nd(v, extra) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [nd(v, extra) for v in node]
        return node.ndim + extra

    segs = build_segments(cfg)
    if len(segs) != len(tree["segments"]) or any(
            len(layers) != seg.n for seg, layers in zip(segs,
                                                        tree["segments"])):
        raise ValueError("tree does not hold the segments of "
                         f"{cfg.name}")
    out = {k: nd(v, 0) for k, v in tree.items() if k != "segments"}
    out["segments"] = [nd(layers, int(seg.n > 1))
                       for seg, layers in zip(segs, tree["segments"])]
    return out


def forward_pipelined(params, cfg: ArchConfig, ctx: RunCtx, batch: dict,
                      *, runner=None, stages: int = 1, replicas: int = 1,
                      microbatches: int = 2, mb_size: int = 1, mesh=None,
                      **kw):
    """Stage-parallel pipelined forward over a (replica, stage) device grid
    (``distributed.pipeline_exec``): the counterpart of :func:`forward` for
    the prefill / scoring path, with the weights resident a stage and the
    microbatches overlapped. ``mesh`` defaults to one CUDA device a grid
    place (``pipeline_exec.make_pipeline_mesh``). Returns ``(logits,
    runner)``; pass ``runner`` back to reuse the placed weights and the
    captured step."""
    if runner is None:
        from repro_torch.distributed import pipeline_exec as pex

        runner = pex.build_lm_pipeline(
            params, cfg, ctx, stages=stages, replicas=replicas,
            microbatches=microbatches, mb_size=mb_size, mesh=mesh, **kw)
    return runner.forward(batch), runner


def decode_step(params, cfg: ArchConfig, ctx: RunCtx, ids, pos, caches):
    """One decode step. ids [B, 1]; pos int or int [B] (per-lane
    positions). Returns (logits [B, V], caches)."""
    logits, caches = forward(params, cfg, ctx, {"ids": ids}, caches=caches,
                             pos=pos)
    return logits[:, -1], caches
