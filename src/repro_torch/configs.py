"""Architecture configs, JAX-free (counterpart of ``repro.models.lm.
ArchConfig``, ``repro.models.vit.ViTConfig`` and ``repro.configs``). Of
the LMs all ten are ported: the four dense ones, ``starcoder2-7b`` and
``nemotron-4-15b`` (full attention), ``h2o-danube-1.8b`` (sliding
window) and ``gemma3-1b`` (5:1 local:global); the two MoE ones,
``mixtral-8x22b`` (8 experts, top-2, sliding window) and
``qwen3-moe-235b-a22b`` (128 experts, top-8, qk-norm); the vlm
``qwen2-vl-7b`` (M-RoPE, the vision front-end stub); the recurrent
``xlstm-125m`` (mLSTM and sLSTM blocks) and ``zamba2-1.2b`` (Mamba2 with a
shared attention block); and the encoder-only ``hubert-xlarge`` (the
audio front-end stub). The paper's two vision workloads, ``vit-b16`` and
``vit-l32``, are in ``VISION_ARCHS``."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    # attention
    attn_pattern: str = "full"  # full | swa | local_global
    window: int = 4096
    lg_ratio: int = 5
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6
    mrope: bool = False
    causal: bool = True
    qk_norm: bool = False
    use_bias: bool = False
    # ffn
    ffn_kind: str = "swiglu"
    norm: str = "rmsnorm"
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_shard: str = "ep"
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    shared_attn_every: int = 0
    slstm_at: tuple = ()
    # frontends
    frontend: str = "none"
    frontend_dim: int = 0
    n_vis_tokens: int = 64
    # misc
    tie_embeddings: bool = False
    remat: bool = True
    supports_decode: bool = True
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


# starcoder2-7b [arXiv:2402.19173]: GQA + RoPE, LN + bias, GELU MLP.
STARCODER2_7B = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152,
    attn_pattern="full", rope_theta=1e5,
    ffn_kind="gelu", norm="layernorm", use_bias=True,
    subquadratic=False,
)

# h2o-danube-1.8b [arXiv:2401.16818]: llama+mistral mix with SWA.
H2O_DANUBE_1_8B = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    attn_pattern="swa", window=4096, rope_theta=1e4,
    ffn_kind="swiglu", norm="rmsnorm",
    subquadratic=True,  # sliding window => bounded KV; runs long_500k
)

# gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global, kv=1, 262k vocab.
GEMMA3_1B = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    attn_pattern="local_global", lg_ratio=5, window=512,
    rope_theta=1e4, rope_theta_global=1e6, qk_norm=True,
    ffn_kind="geglu", norm="rmsnorm", tie_embeddings=True,
    subquadratic=True,  # 5:1 local; the few global layers have kv=1
)

# nemotron-4-15b [arXiv:2402.16819]: GQA, squared-ReLU MLP.
NEMOTRON4_15B = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    attn_pattern="full", rope_theta=1e4,
    ffn_kind="relu2", norm="layernorm",
    subquadratic=False,  # full attention => long_500k skipped
)

# mixtral-8x22b [arXiv:2401.04088]: 8 experts top-2, SWA.
MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, moe_shard="tp",
    attn_pattern="swa", window=4096, rope_theta=1e6,
    ffn_kind="swiglu", norm="rmsnorm",
    subquadratic=True,
)

# qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family]: 128 experts top-8.
QWEN3_MOE_235B = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, top_k=8, moe_shard="ep",
    attn_pattern="full", rope_theta=1e6, qk_norm=True,
    ffn_kind="swiglu", norm="rmsnorm",
    subquadratic=False,
)

# qwen2-vl-7b [arXiv:2409.12191]: M-RoPE decoder; the vision front end is
# a stub (precomputed patch embeddings through ``front_proj``).
QWEN2_VL_7B = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    attn_pattern="full", rope_theta=1e6, mrope=True,
    ffn_kind="swiglu", norm="rmsnorm",
    frontend="vision", frontend_dim=1176, n_vis_tokens=64,
    subquadratic=False,
)

# hubert-xlarge [arXiv:2106.07447]: encoder-only audio transformer; the
# front end is a stub (precomputed frame embeddings through
# ``front_proj``).
HUBERT_XLARGE = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    causal=False, attn_pattern="full",
    ffn_kind="gelu", norm="layernorm", use_bias=True,
    frontend="audio", frontend_dim=512,
    supports_decode=False,
    subquadratic=False,
)

# zamba2-1.2b [arXiv:2411.15242]: Mamba2 backbone + shared attention.
ZAMBA2_1_2B = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, shared_attn_every=6,
    attn_pattern="full", rope_theta=1e4,
    ffn_kind="gelu", norm="rmsnorm",
    subquadratic=True,
)

# xlstm-125m [arXiv:2405.04517]: sLSTM + mLSTM blocks (d_ff 0: the blocks
# carry their own projections).
XLSTM_125M = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_at=(3, 9),
    norm="rmsnorm", tie_embeddings=True,
    subquadratic=True,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (H2O_DANUBE_1_8B, STARCODER2_7B, GEMMA3_1B,
                        NEMOTRON4_15B, MIXTRAL_8X22B, QWEN3_MOE_235B,
                        HUBERT_XLARGE, ZAMBA2_1_2B, XLSTM_125M,
                        QWEN2_VL_7B)}


class Shape(NamedTuple):
    """An input shape (the reference's ``repro.configs.Shape``)."""

    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape(4096, 256, "train"),
    "prefill_32k": Shape(32768, 32, "prefill"),
    "decode_32k": Shape(32768, 128, "decode"),
    "long_500k": Shape(524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Which of the four shapes run for this arch (the reference's rule):
    train and prefill always; decode with a decode step; ``long_500k``
    only sub-quadratic."""
    out = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        out.append("decode_32k")
        if cfg.subquadratic:
            out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell of the dry-run."""
    return [(a, s) for a, c in ARCHS.items() for s in applicable_shapes(c)]


def skipped_cells() -> list[tuple[str, str, str]]:
    """The (arch, shape, why) cells that do not run."""
    out = []
    for a, c in ARCHS.items():
        for s in SHAPES:
            if s in applicable_shapes(c):
                continue
            why = ("encoder-only (no decode step)" if not c.supports_decode
                   else "pure full attention (long_500k needs "
                        "sub-quadratic)")
            out.append((a, s, why))
    return out


def input_specs(cfg: ArchConfig, shape, device="meta") -> dict:
    """Empty tensors standing for every model input of this cell (on
    ``meta`` by default: shapes and dtypes only, the reference's
    ``ShapeDtypeStruct``s). train / prefill: the step's batch; decode:
    ``ids`` [B, 1] and the scalar ``pos`` (the caches come from
    ``models.lm.init_cache``)."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = sh.batch, sh.seq
    f32, i32 = torch.float32, torch.int32

    def t(size, dtype):
        return torch.empty(size, dtype=dtype, device=device)

    if sh.kind == "decode":
        return {"ids": t((b, 1), i32), "pos": t((), i32)}
    batch: dict = {}
    if cfg.frontend == "audio":
        batch["emb"] = t((b, s, cfg.frontend_dim), f32)
    else:
        batch["ids"] = t((b, s), i32)
    if cfg.frontend == "vision":
        batch["vis_emb"] = t((b, cfg.n_vis_tokens, cfg.frontend_dim), f32)
    if sh.kind == "train":
        batch["labels"] = t((b, s), i32)
        batch["loss_mask"] = t((b, s), f32)
    return batch


def concrete_inputs(cfg: ArchConfig, shape, seed: int = 0,
                    device=None) -> dict:
    """Random inputs matching :func:`input_specs` on ``device`` (the
    reference's ``concrete_inputs``, from a torch generator): ids and
    labels in the vocabulary, normal embeddings, an all-ones loss mask."""
    dev = torch.device("cuda" if device is None else device)
    gen = torch.Generator(dev).manual_seed(seed)
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if v.dtype == torch.int32:
            hi = cfg.vocab_size if k in ("ids", "labels") else 2 ** 30
            out[k] = torch.randint(0, hi, v.shape, generator=gen,
                                   dtype=torch.int32, device=dev)
        else:
            out[k] = torch.randn(v.shape, generator=gen, dtype=v.dtype,
                                 device=dev)
    if "loss_mask" in out:
        out["loss_mask"] = torch.ones_like(out["loss_mask"])
    return out


def tiny(cfg: ArchConfig, seq: int = 32) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    ``repro.configs.tiny``)."""
    over: dict = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=128,
        window=min(cfg.window, 16),
    )
    if cfg.attn_pattern == "local_global":
        over.update(n_layers=2 * (cfg.lg_ratio + 1), lg_ratio=cfg.lg_ratio)
    elif cfg.family == "hybrid":
        over.update(n_layers=5, shared_attn_every=2, ssm_state=16,
                    ssm_head_dim=16)
    elif cfg.family == "ssm":
        over.update(n_layers=4, slstm_at=(1,))
    else:
        over.update(n_layers=2)
    if cfg.n_experts:
        over.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.frontend != "none":
        over.update(frontend_dim=24, n_vis_tokens=8)
    return dataclasses.replace(cfg, **over)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Encoder-only Vision Transformer (counterpart of
    ``repro.models.vit.ViTConfig``)."""

    name: str
    image_size: int
    patch_size: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    in_channels: int = 3
    head_dim: int = 0
    ffn_kind: str = "gelu"
    norm: str = "layernorm"
    use_bias: bool = True
    remat: bool = False
    chips: int = 1  # FWS stage partition (dual-chip vit-l32)
    # unused by the encoder; kept so the fields match the reference's
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    @property
    def grid(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is not a "
                             f"multiple of patch_size {self.patch_size}")
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.n_patches + 1  # CLS token

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


# vit-b16 [ViT-B/16, 224 px]: the paper's single-chip headline workload
# (Table 7: 41,269 FPS on the modelled Base system; N = 14*14 + 1 = 197).
VIT_B16 = ViTConfig(
    name="vit-b16", image_size=224, patch_size=16,
    n_layers=12, d_model=768, n_heads=12, d_ff=3072, n_classes=1000,
    ffn_kind="gelu", norm="layernorm", use_bias=True,
)

# vit-l32 [ViT-L/32, 384 px]: the paper's dual-chip headline workload
# (Table 7: 58,275 FPS on two modelled Large chips; N = 12*12 + 1 = 145;
# 24 encoder blocks split 12+12 over the two chips).
VIT_L32 = ViTConfig(
    name="vit-l32", image_size=384, patch_size=32,
    n_layers=24, d_model=1024, n_heads=16, d_ff=4096, n_classes=1000,
    ffn_kind="gelu", norm="layernorm", use_bias=True, chips=2,
)

VISION_ARCHS: dict[str, ViTConfig] = {c.name: c for c in (VIT_B16, VIT_L32)}


def tiny_vit(cfg: ViTConfig) -> ViTConfig:
    """Reduced vision config for CPU smoke tests. patch_dim stays
    32-aligned (8*8*3 = 192) so the patch embedding remains
    analog-eligible."""
    return dataclasses.replace(
        cfg, image_size=32, patch_size=8, n_layers=2, d_model=64,
        n_heads=4, head_dim=16, d_ff=96, n_classes=32, chips=1,
    )


def geometry_tiny_vit(cfg: ViTConfig) -> ViTConfig:
    """Width-reduced but geometry-true: the same image and patch grid (so
    the same token count N), layer count and chip split as the full
    workload (the shape the FWS pipeline model bills), with a tiny
    d_model and d_ff."""
    return dataclasses.replace(
        cfg, d_model=64, n_heads=4, head_dim=16, d_ff=96, n_classes=32,
    )
