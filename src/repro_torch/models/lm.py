"""Decoder LM over segments of identical blocks (counterpart of
``repro.models.lm``): attention + FFN blocks (``attn``) and attention +
MoE blocks (``moe_attn``: mixtral-8x22b, qwen3-moe-235b-a22b) under full
attention (starcoder2-7b), a sliding window (h2o-danube-1.8b, mixtral)
or runs of local and global layers (gemma3-1b's 5:1 pattern, one segment
a run), with RoPE or M-RoPE (qwen2-vl-7b, whose vision front end is the
reference's stub: ``front_proj`` on precomputed patch embeddings). The
recurrent families (SSM, xLSTM, the Zamba hybrid) and the audio front end
are not ported.

The layer stack runs as a Python loop over unstacked layers: the
reference's ``unroll_layers=True`` mode, the one in which it pins bitwise
MXFP4 identity. Parameters keep the reference's tree (``embed``,
``segments``, ``final_ln``, ``lm_head``) with one dict per layer under
``segments[i]`` where the reference stacks a leading layer axis. Caches
are likewise one dict per layer.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ArchConfig
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import ffn as ffn_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.layers import rope as ropelib
from repro_torch.layers.backends import layer_paths
from repro_torch.layers.common import (
    RunCtx,
    embed_apply,
    embed_init,
    linear_apply,
    linear_init,
    norm_apply,
    norm_init,
)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # "attn" | "moe_attn" (the recurrent kinds are not ported)
    n: int
    attn: attn_mod.AttnStatic | None = None


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


def build_segments(cfg: ArchConfig) -> list[Segment]:
    """The reference's segments of an attention LM (the dense, MoE and vlm
    families): one segment of every layer, or, for ``local_global``, one a
    run of local or global layers (layer i is global when ``i % (lg_ratio
    + 1) == lg_ratio``; gemma3-1b's 26 layers are L5 G1 L5 G1 L5 G1 L5 G1
    L2). A config with experts gets ``moe_attn`` segments."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported (ROADMAP.md "
            "Queue 1 item 7); the dense, MoE and vlm families are")
    kind = "moe_attn" if cfg.n_experts else "attn"
    if cfg.attn_pattern != "local_global":
        return [Segment(kind, cfg.n_layers, attn=_attn_static(cfg))]
    glob = [i % (cfg.lg_ratio + 1) == cfg.lg_ratio
            for i in range(cfg.n_layers)]
    segs: list[Segment] = []
    i = 0
    while i < cfg.n_layers:
        j = i
        while j < cfg.n_layers and glob[j] == glob[i]:
            j += 1
        segs.append(Segment(kind, j - i,
                            attn=_attn_static(cfg, is_global=glob[i])))
        i = j
    return segs


# ---------------------------------------------------------------- init

def init_model(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random float32 parameters on ``gen``'s device."""
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model)}
    if cfg.frontend != "none":
        params["front_proj"] = linear_init(gen, cfg.frontend_dim, cfg.d_model)
    params["segments"] = [[block_init(gen, cfg, seg) for _ in range(seg.n)]
                          for seg in build_segments(cfg)]
    params["final_ln"] = norm_init(cfg.norm, cfg.d_model, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size)
    return params


def block_init(gen: torch.Generator, cfg, seg: Segment) -> dict:
    """One layer's parameters: the attention sublayer, then the FFN or,
    in a ``moe_attn`` segment, the MoE (``cfg`` needs ``d_model``,
    ``d_ff``, ``ffn_kind``, ``norm`` and ``use_bias``, and ``n_experts``
    for MoE: an ``ArchConfig`` or a ``ViTConfig``)."""
    p = {"attn": attn_mod.attn_init(gen, seg.attn)}
    if seg.kind == "moe_attn":
        p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, cfg.ffn_kind, cfg.norm)
    else:
        p["ffn"] = ffn_mod.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                    cfg.norm, cfg.use_bias)
    return p


# --------------------------------------------------------------- caches

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               mx_digital: bool = False, fused: bool = False,
               device=None) -> list:
    """Decode caches: per segment, one fused page dict per layer, on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"`` is given)."""
    return [
        [attn_mod.attn_cache_init(seg.attn, batch, max_len,
                                  mx_digital=mx_digital, fused=fused,
                                  device=device)
         for _ in range(seg.n)]
        for seg in build_segments(cfg)
    ]


def cache_specs(cfg: ArchConfig, mx_digital: bool = False,
                fused: bool = False) -> list:
    """Logical axes of each cache leaf, per segment (shared by its
    layers; no stacked layer axis)."""
    return [dict(attn_mod.attn_cache_specs(mx_digital, fused=fused))
            for _ in build_segments(cfg)]


# -------------------------------------------------------------- forward

def forward(params, cfg: ArchConfig, ctx: RunCtx, batch: dict, caches=None,
            pos=None, return_hidden: bool = False):
    """batch: {'ids', optional 'positions', optional 'vis_emb'}. Returns
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
    new_caches = []
    for i, seg in enumerate(build_segments(cfg)):
        x, seg_caches = run_segment(
            ctx, cfg, seg, params["segments"][i], x, positions,
            caches[i] if caches is not None else None, pos,
            path=f"segments/{i}")
        new_caches.append(seg_caches)
    x = norm_apply(cfg.norm, params["final_ln"], x)
    if return_hidden:
        return x, new_caches
    return _head(ctx, cfg, params, x), new_caches


def run_segment(ctx: RunCtx, cfg, seg: Segment, layers: list, x, positions,
                caches: list | None = None, pos=None, *, path: str):
    """Run one segment's layers (attention, then FFN, each pre-norm with
    its residual) over ``x``: the counterpart of the reference's
    ``lm._run_segment`` in its unrolled mode. ``cfg`` needs ``ffn_kind``
    and ``norm`` (an ``ArchConfig`` or a ``ViTConfig``; and ``top_k`` and
    ``capacity_factor`` for a ``moe_attn`` segment, whose MoE runs under
    the capture scope ``moe``). Each layer's
    capture scope is ``<path>/L<j>``, or ``<path>`` for a single layer
    (``layers/backends.py::layer_paths``). Returns (x, the layers' new
    caches, None each without ``caches``)."""
    a = seg.attn
    tables = (ropelib.rope_tables(positions, a.head_dim, a.rope_theta)
              if a.use_rope and not a.mrope else None)
    new_caches = []
    for j, (pj, lpath) in enumerate(zip(layers,
                                        layer_paths(path, len(layers)))):
        lctx = ctx.scoped(lpath)
        cj = caches[j] if caches is not None else None
        x, nc = attn_mod.attn_apply(lctx.scoped("attn"), a, pj["attn"], x,
                                    positions, cj, pos, rope_tables=tables)
        if seg.kind == "moe_attn":
            x = moe_mod.moe_apply(lctx.scoped("moe"), cfg.ffn_kind,
                                  cfg.norm, pj["moe"], x, cfg.top_k,
                                  cfg.capacity_factor)
        else:
            x = ffn_mod.ffn_apply(lctx.scoped("ffn"), cfg.ffn_kind, cfg.norm,
                                  pj["ffn"], x)
        new_caches.append(nc)
    return x, new_caches


def embed_inputs(ctx: RunCtx, cfg: ArchConfig, params, batch: dict):
    """Token embeddings (bf16); for the vision front end with
    ``batch["vis_emb"]`` [B, nv, frontend_dim], ``front_proj`` of the patch
    embeddings replaces the first ``nv`` token embeddings (the reference's
    stub). The audio front end is not ported."""
    if cfg.frontend == "audio":
        raise NotImplementedError(f"{cfg.name}: the audio front end is not "
                                  "ported (ROADMAP.md Queue 1 item 7)")
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


def decode_step(params, cfg: ArchConfig, ctx: RunCtx, ids, pos, caches):
    """One decode step. ids [B, 1]; pos int or int [B] (per-lane
    positions). Returns (logits [B, V], caches)."""
    logits, caches = forward(params, cfg, ctx, {"ids": ids}, caches=caches,
                             pos=pos)
    return logits[:, -1], caches
