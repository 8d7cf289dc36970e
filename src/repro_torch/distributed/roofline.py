"""Roofline terms, collective traffic and model FLOPs (counterpart of the
reference's ``repro.distributed.roofline``).

:func:`roofline_terms` turns a step's per-device cost (FLOPs, bytes) into
the time each would take at the card's peak: compute = FLOPs / peak,
memory = bytes / HBM rate, on the NVIDIA H100 SXM's constants (989e12
dense bf16 FLOP/s, 3.35e12 B/s; the ``hopper-kernels`` guide, as
``chip_smoke.py``'s bounds). The costs come from the port's meta-device
counter (``obs.cost``, ``distributed.blockwise.analyze_cell``).

:class:`CollectiveStats` is what the stage pipeline's transfer guard
fills (``pipeline_exec.StagePipeline.collectives``): the bytes each
activation hop moves between stages, under the reference's name for that
hop, ``collective-permute``. :func:`active_params` and
:func:`model_flops` are pure arithmetic on a config.

Not here: the reference's ``parse_collectives``. It reads the collectives
out of XLA's partitioned HLO text, and the port produces none (it runs
no GSPMD program), so a GSPMD cell's collective term is None
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # H100 SXM dense bf16
HBM_BW = 3.35e12  # H100 SXM HBM3, bytes/s


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0  # bytes moved between devices
    by_kind: dict = dataclasses.field(default_factory=dict)  # kind: [n, B]
    count: int = 0

    def add(self, kind: str, n_bytes: float) -> None:
        """Record one transfer of ``n_bytes`` under ``kind``."""
        self.wire_bytes += n_bytes
        k = self.by_kind.setdefault(kind, [0, 0.0])
        k[0] += 1
        k[1] += n_bytes
        self.count += 1


def roofline_terms(cost: dict, collectives: CollectiveStats | None,
                   n_devices: int) -> dict:
    """The roofline terms of a per-device ``cost`` (``flops``, ``bytes
    accessed``) with the reference's keys. ``collectives`` None (a GSPMD
    cell: the port has no partitioned program to read them from) gives
    ``t_collective_s`` None, and ``dominant`` is the larger of compute
    and memory; a ``CollectiveStats`` (per-device wire bytes) has no link
    rate here either, so its term is None too and only its bytes are
    reported. ``n_devices`` is the mesh's size (the costs are already per
    device)."""
    del n_devices
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    dom = "compute" if t_compute >= t_memory else "memory"
    total = max(t_compute, t_memory)
    coll = collectives or CollectiveStats()
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": None,
        "dominant": dom,
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": byts,
        "collective_wire_bytes_per_dev": coll.wire_bytes,
        "collective_by_kind": {k: {"count": v[0], "wire_bytes": v[1]}
                               for k, v in coll.by_kind.items()},
        "roofline_fraction": (t_compute / total) if total > 0 else 0.0,
    }


def model_flops(cfg, shape, n_tokens_override=None) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N_active*D for inference (D =
    tokens a step). ``shape`` has ``seq``, ``batch`` and ``kind``
    (``train`` | ``prefill`` | ``decode``), as the reference's
    ``configs.Shape``."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.batch * shape.seq
    return 2.0 * n_active * shape.batch  # decode: one token a sequence


def active_params(cfg) -> float:
    """Active parameter count (MoE counts top_k experts only)."""
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd = cfg.hd
    attn = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)
    glu = cfg.ffn_kind in ("swiglu", "geglu")
    ffp = d * ff * (3 if glu else 2)
    total = 0.0
    if cfg.family in ("dense", "audio", "vlm"):
        total = L * (attn + ffp)
    elif cfg.family == "moe":
        total = L * (attn + cfg.top_k * ffp + d * cfg.n_experts)
    elif cfg.family == "hybrid":
        di = 2 * d
        gn = cfg.ssm_state
        h = di // cfg.ssm_head_dim
        mamba = d * (2 * di + 2 * gn + h) + di * d
        shared = (2 * d) * d + attn + ffp + d * d
        n_shared = L // max(cfg.shared_attn_every, 1)
        total = L * mamba + n_shared * shared
    elif cfg.family == "ssm":
        di = int(d * 2.0)
        mlstm = d * 2 * di + 3 * di * di + di * d
        slstm = (d * 4 * d + 4 * d * (d // cfg.n_heads)
                 + int(d * 4 / 3) * 2 * d + int(d * 4 / 3) * d)
        n_s = len(cfg.slstm_at)
        total = (L - n_s) * mlstm + n_s * slstm
    total += v * d * (1 if cfg.tie_embeddings else 2)
    return total
