"""Shared layer utilities: the run context, the backend-dispatched linear,
norms and the embedding (counterpart of ``repro.layers.common``).

Parameters are plain nested dicts of tensors. Random initialisation takes
an explicit ``torch.Generator`` on the target device; the port never
compares two random inits with the reference (the RNGs differ), weights
cross through :func:`repro_torch.convert.from_reference` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.layers import backends as backends_lib


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call context threaded through the model.

    ``quant`` names a linear-execution backend (``none -> float_bf16``,
    ``cim -> cim_analog``); unknown names raise ``ValueError``. ``impl``:
    ``"auto"`` routes the analog and packed-MXFP4 linears and the fused
    paged decode through the kernel wrappers (CUDA kernel on CUDA tensors,
    its plain version on CPU tensors), and on CUDA the float prefill past
    ``dense_attn_max`` through the ``flash_attention`` kernel; ``"ref"``
    runs the reference's own compositions instead (blockwise
    ``core.cim.cim_linear``, the bf16 ``_dequant_packed`` matmul, the
    dense whole-key-axis ``ragged_paged_decode_ref`` and the torch-op
    ``_flash_attn``), as the JAX package does off the TPU.
    """

    quant: str = "none"
    impl: str = "auto"  # auto | ref
    attn_chunk: int = 1024  # KV tile of the online-softmax prefill
    q_chunk: int = 2048  # query tile of the online-softmax prefill
    dense_attn_max: int = 2048  # prefill longer than this needs flash attn
    cim: Any = None  # CIMConfig for the cim_analog backend
    tap: Any = None  # ActivationTap during calibration capture
    scope: str = ""  # param-tree path prefix while a tap is active
    # int [batch] pool row per lane for the fused paged decode (None: lane
    # i reads cache row i)
    paged_rows: Any = None
    # the caller's positions are [0, 1, ..., n) on every row, right-padded
    # with KV_PAD (engine prefill, lm.forward without positions): the
    # layout the flash_attention kernel assumes; nothing reads the
    # positions back to the host to check it
    arange_positions: bool = False
    obs: Any = None  # repro_torch.obs.Obs (kernel dispatch counters)
    # numerical-fidelity probe (repro_torch.obs.FidelityProbe) during an
    # eager instrumented run: per-layer MXFP4 / ADC health keyed by the
    # same scoped paths as calibration. None (the default) leaves every
    # forward and captured step as it is.
    fidelity: Any = None

    def __post_init__(self):
        if self.impl not in ("auto", "ref"):
            raise ValueError(f"unknown impl {self.impl!r} (auto | ref)")

    def scoped(self, name: str) -> "RunCtx":
        """Extend the capture scope; a no-op unless a tap or a fidelity
        probe is active."""
        if self.tap is None and self.fidelity is None:
            return self
        return dataclasses.replace(
            self, scope=f"{self.scope}/{name}" if self.scope else name)

    @property
    def hybrid_digital_sdpa(self) -> bool:
        """SDPA runs on the digital MXFP4 path under the hybrid analog
        backend and the fully-digital MXFP4 eval mode (paper §4.4-4.5)."""
        return self.quant in ("cim", "cim_analog", "mxfp4_digital")


# ----------------------------------------------------------------- linear

def linear_init(gen: torch.Generator, k: int, n: int, *,
                use_bias: bool = False) -> dict:
    """N(0, 1/k) weights [K, N] (f32), optional zero bias."""
    scale = (1.0 / k) ** 0.5
    dev = gen.device
    w = torch.randn((k, n), generator=gen, dtype=torch.float32, device=dev)
    params = {"w": w.mul_(scale)}
    if use_bias:
        params["b"] = torch.zeros((n,), dtype=torch.float32, device=dev)
    return params


def linear_apply(ctx: RunCtx, params: dict, x: torch.Tensor,
                 name: str | None = None) -> torch.Tensor:
    """Backend-dispatched linear, x [..., K] (bf16). Converted-param
    markers win, otherwise ``ctx.quant`` names the backend. ``name`` is the
    call site's param key; with an active tap it extends ``ctx.scope`` into
    the param-tree path that keys Row-Hist calibration; with an active
    fidelity probe the linear's input is probed under the same path."""
    if ctx.tap is not None and name is not None:
        path = f"{ctx.scope}/{name}" if ctx.scope else name
        ctx.tap.record(path, params, x)
    if ctx.fidelity is not None and name is not None:
        path = f"{ctx.scope}/{name}" if ctx.scope else name
        ctx.fidelity.observe_linear(path, ctx, params, x)
    y = backends_lib.resolve_backend(ctx, params).forward(ctx, params, x)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ------------------------------------------------------------------ norms

def rmsnorm_init(d: int, device) -> dict:
    return {"gamma": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["gamma"]
    return y.to(x.dtype)


def layernorm_init(d: int, device) -> dict:
    return {"gamma": torch.ones((d,), dtype=torch.float32, device=device),
            "beta": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["gamma"] + params["beta"]
    return y.to(x.dtype)


def norm_init(kind: str, d: int, device) -> dict:
    return rmsnorm_init(d, device) if kind == "rmsnorm" else \
        layernorm_init(d, device)


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm_apply(params, x)
    return layernorm_apply(params, x)


# ------------------------------------------------------------- embeddings

def embed_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    emb = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                      device=gen.device)
    return {"emb": emb.mul_(d ** -0.5)}


def embed_apply(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["emb"].to(torch.bfloat16)[ids]


# ---------------------------------------------------- serving conversion

def convert_params_mxfp4(tree, min_n: int = 256, free: bool = False):
    """Serving transform: every static linear weight with a 32-aligned
    contraction dim and at least ``min_n`` outputs becomes packed MXFP4
    (4.25 b/param resident, the ``mxfp4_wonly`` node; its bias stays as it
    is); MoE expert banks ``w1`` / ``w2`` / ``w3`` [E, K, N] become packed
    banks [E, K//2, N] (``backends.quantize_bank``); every other float32
    leaf is cast to bf16. The reference's gate, over the port's tree of
    one dict per layer. An MoE router stays a bf16 leaf at any expert
    count: the router is read as a raw weight (``layers/moe.py``), never
    through ``linear_apply``. (The reference packs a router with E >=
    ``min_n`` too, and its ``moe_apply`` then fails to find the router's
    ``w``: qwen3-moe-235b-a22b's 128 experts at ``min_n`` 32.) With
    ``free`` each layer's float dict is dropped from ``tree`` once it is
    converted (``tree`` is left with ``None`` for each layer), as
    ``backends.convert_params_cim`` does."""

    def rec(node, key=""):
        if isinstance(node, dict):
            w = node.get("w")
            if (key != "router" and w is not None and w.ndim == 2
                    and w.shape[0] % 32 == 0 and w.shape[1] >= min_n):
                out = backends_lib.quantize_linear_params(node)
                out.update({k: rec(v, k) for k, v in node.items()
                            if k not in ("w", "b")})
                return out
            return {k: backends_lib.quantize_bank(v)
                    if backends_lib.is_expert_bank(k, v) else rec(v, k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = []
            for j, v in enumerate(node):  # "segments": its lists of layers
                out.append(rec(v, key))
                if free and key == "segments" and isinstance(v, dict):
                    node[j] = None
            return out
        if torch.is_tensor(node) and node.dtype == torch.float32:
            return node.to(torch.bfloat16)
        return node

    return rec(tree)
