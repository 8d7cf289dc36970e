"""Per-layer serving costs for stage balancing (counterpart of the
reference's ``repro.distributed.blockwise.serve_layer_costs``, copied:
that module compiles blocks with XLA).

Only :func:`serve_layer_costs` is here. The reference's ``analyze_cell``
reads XLA's compiled cost analysis for the dry-run and training tools,
which are not ported yet (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

from repro_torch.configs import ViTConfig
from repro_torch.models import lm
from repro_torch.models import vit as vit_mod


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
