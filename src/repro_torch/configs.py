"""Architecture configs, JAX-free (counterpart of ``repro.models.lm.
ArchConfig`` and ``repro.configs``). Only the dense ``starcoder2-7b`` is
ported so far; the other families are listed in ROADMAP.md."""

from __future__ import annotations

import dataclasses


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

ARCHS: dict[str, ArchConfig] = {STARCODER2_7B.name: STARCODER2_7B}


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
