"""Encoder-only Vision Transformer on the hybrid CIM layer stack
(counterpart of ``repro.models.vit``): the paper's own workload.

Patch embedding as unfold + linear (so it dispatches through
``layers/backends.py`` like every other static linear), a learned CLS
token and position embeddings, pre-LN encoder blocks run by
``lm.run_segment`` (the same ``segments/<i>/L<j>/...`` capture paths, so
Row-Hist calibration and ``convert_params_cim`` work unchanged), and a
classifier over the CLS row.

Encoder semantics: bidirectional attention (``causal=False``), no RoPE,
full MHA, no KV cache and no decode step: one fixed-shape forward a
batch of images. Parameters keep the reference's tree (``patch``,
``cls`` [1, 1, d], ``pos`` [1, S, d], ``segments``, ``final_ln``,
``head``) with one dict per layer under ``segments[0]`` where the
reference stacks a leading layer axis.

Dual-chip deployments (vit-l32: 24 blocks split 12+12, paper §5.3) slice
the trunk with ``distributed.sharding.stage_partition``:
:func:`split_chips` and :func:`forward_chip`; ``serving/vision.py`` runs
the chip chain with the hidden state handed from one chip's step to the
next. :func:`forward_pipelined` runs the stages at once instead, on a
device grid (``distributed.pipeline_exec``), microbatches overlapped.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs import ViTConfig
from repro_torch.distributed.sharding import stage_partition
from repro_torch.layers import attention as attn_mod
from repro_torch.layers.common import (
    RunCtx,
    linear_apply,
    linear_init,
    norm_apply,
    norm_init,
)
from repro_torch.models import lm


def _attn_static(cfg: ViTConfig) -> attn_mod.AttnStatic:
    return attn_mod.AttnStatic(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv=cfg.n_heads,  # encoder: full MHA, no GQA
        head_dim=cfg.hd, causal=False,
        use_rope=False,  # learned absolute position embeddings
        use_bias=cfg.use_bias, norm=cfg.norm,
    )


def build_segments(cfg: ViTConfig) -> list[lm.Segment]:
    return [lm.Segment("attn", cfg.n_layers, attn=_attn_static(cfg))]


# ---------------------------------------------------------------- init

def init_model(cfg: ViTConfig, gen: torch.Generator) -> dict:
    """Random float32 parameters on ``gen``'s device."""
    d, dev = cfg.d_model, gen.device
    seg = build_segments(cfg)[0]
    params: dict = {"patch": linear_init(gen, cfg.patch_dim, d,
                                         use_bias=cfg.use_bias)}
    params["cls"] = torch.randn((1, 1, d), generator=gen, device=dev) * 0.02
    params["pos"] = torch.randn((1, cfg.seq_len, d), generator=gen,
                                device=dev) * 0.02
    params["segments"] = [[lm.block_init(gen, cfg, seg)
                           for _ in range(seg.n)]]
    params["final_ln"] = norm_init(cfg.norm, d, dev)
    params["head"] = linear_init(gen, d, cfg.n_classes, use_bias=cfg.use_bias)
    return params


# -------------------------------------------------------------- forward

def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] non-overlapping unfold."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def embed_images(ctx: RunCtx, cfg: ViTConfig, params: dict,
                 images: torch.Tensor) -> torch.Tensor:
    """Patch embedding of the f32 patches, the CLS token prepended, the
    learned positions added, then bf16."""
    x = patchify(images.to(torch.float32), cfg.patch_size)
    x = linear_apply(ctx, params["patch"], x, name="patch")
    cls = params["cls"].to(x.dtype).expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos"].to(x.dtype)
    return x.to(torch.bfloat16)


def encode(layers: list, cfg: ViTConfig, ctx: RunCtx,
           x: torch.Tensor) -> torch.Tensor:
    """The encoder trunk over ``layers`` (all of them, or one chip's
    slice), scoped ``segments/0``."""
    seg = lm.Segment("attn", len(layers), attn=_attn_static(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, _ = lm.run_segment(ctx, cfg, seg, layers, x, positions,
                          path="segments/0")
    return x


def head(ctx: RunCtx, cfg: ViTConfig, params: dict,
         x: torch.Tensor) -> torch.Tensor:
    """Final LN, the CLS row, the classifier -> [B, n_classes]."""
    x = norm_apply(cfg.norm, params["final_ln"], x)
    return linear_apply(ctx, params["head"], x[:, :1], name="head")[:, 0]


def forward(params: dict, cfg: ViTConfig, ctx: RunCtx, batch: dict,
            caches=None, pos=None, return_hidden: bool = False):
    """batch: {'images': [B, H, W, C] float}. Returns (logits [B, classes]
    or the normed hidden [B, S, d], None): the ``(out, caches)`` contract
    of ``lm.forward`` with no cache, so calibration treats both model
    families alike."""
    del caches, pos  # encoder: no KV cache, no decode step
    x = embed_images(ctx, cfg, params, batch["images"])
    x = encode(params["segments"][0], cfg, ctx, x)
    if return_hidden:
        return norm_apply(cfg.norm, params["final_ln"], x), None
    return head(ctx, cfg, params, x), None


def forward_pipelined(params, cfg: ViTConfig, ctx: RunCtx, batch: dict,
                      *, runner=None, stages: int | None = None,
                      replicas: int = 1, microbatches: int = 2,
                      mb_size: int = 1, mesh=None, **kw):
    """Stage-parallel pipelined encoder forward over a (replica, stage)
    device grid (``distributed.pipeline_exec``): the executable form of
    the multi-chip FWS deployment that :func:`split_chips` /
    :func:`forward_chip` chain in sequence; ``stages`` defaults to
    ``cfg.chips``. Returns ``(logits, runner)``; pass ``runner`` back to
    keep the resident stage weights and the captured step."""
    if runner is None:
        from repro_torch.distributed import pipeline_exec as pex

        runner = pex.build_vit_pipeline(
            params, cfg, ctx, stages=stages or cfg.chips, replicas=replicas,
            microbatches=microbatches, mb_size=mb_size, mesh=mesh, **kw)
    return runner.forward(batch), runner


# ------------------------------------------------------- chip partition

def split_chips(params: dict, cfg: ViTConfig,
                n_chips: int | None = None) -> list:
    """Slice the trunk into per-chip parameter trees with
    ``stage_partition`` (vit-l32: 24 layers -> 12+12): ``[(chip_params,
    n_layers), ...]``. Chip 0 keeps the embedding front (patch, cls,
    pos); the last chip keeps final_ln and the head. Float, packed-MXFP4
    and CIM-converted trees alike: each layer's dict (weights, codes,
    exps, its ``e_n`` / ``adc_fs``) moves whole."""
    n_chips = n_chips or cfg.chips
    layers = params["segments"][0]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.n_layers}")
    chips = []
    for ci, (lo, hi) in enumerate(stage_partition(cfg.n_layers, n_chips)):
        sub: dict = {"segments": [layers[lo:hi]]}
        if ci == 0:
            sub.update({k: params[k] for k in ("patch", "cls", "pos")})
        if ci == n_chips - 1:
            sub.update({k: params[k] for k in ("final_ln", "head")})
        chips.append((sub, hi - lo))
    return chips


def forward_chip(chip_params: dict, cfg: ViTConfig, ctx: RunCtx, inp,
                 n_layers: int, first: bool, last: bool) -> torch.Tensor:
    """One chip's share: ``inp`` is the image batch on the first chip and
    the previous chip's hidden state (the inter-chip hop) otherwise.
    Returns logits on the last chip, the hidden state else."""
    layers = chip_params["segments"][0]
    if len(layers) != n_layers:
        raise ValueError(f"chip holds {len(layers)} layers, not {n_layers}")
    x = (embed_images(ctx, cfg, chip_params, inp) if first
         else inp.to(torch.bfloat16))
    x = encode(layers, cfg, ctx, x)
    if last:
        return head(ctx, cfg, chip_params, x)
    return x


# ----------------------------------------------------------- calibration

def calibration_images(cfg: ViTConfig, n_batches: int = 2, batch: int = 2,
                       seed: int = 1234, device=None) -> list:
    """Synthetic image batches for Row-Hist calibration, from a seeded
    ``torch.Generator`` (not the reference's jax.random stream), on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"`` is given)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    return [{"images": torch.randn(shape, generator=gen, device=device)}
            for _ in range(n_batches)]
