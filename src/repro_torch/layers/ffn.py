"""Feed-forward variants (counterpart of ``repro.layers.ffn``): gelu /
squared-relu MLPs and swiglu / geglu GLUs."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.layers.common import (
    RunCtx,
    init_device,
    linear_apply,
    linear_init,
    linear_specs,
    norm_apply,
    norm_init,
    norm_specs,
)

GLU_KINDS = ("swiglu", "geglu")


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU as ``jax.nn.gelu`` writes it, op by op in the
    input's dtype: in bf16 each op rounds, as in the reference. A fused
    f32 GELU rounds once, and its bf16 outputs differ by an ulp often
    enough that the MXFP4 quantizer downstream flips codes."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype)
    # in x's dtype, as jax.nn.gelu takes it (a Python float acts in f32)
    a = torch.tensor(0.044715, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x))))
    return x * cdf


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it, x * 1 / (1 + exp(-x)) op by op in
    the input's dtype: in bf16 each op rounds, bitwise the reference's; a
    fused ``F.silu`` rounds once and differs in about a third of bf16
    outputs."""
    return x * (1 / (1 + torch.exp(-x)))


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind in ("gelu", "geglu"):  # jax.nn.gelu defaults to the tanh form
        return _gelu_tanh(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    if kind == "swiglu":
        return _silu(x)
    raise ValueError(kind)


def ffn_init(gen: torch.Generator, d: int, d_ff: int, kind: str, norm: str,
             use_bias: bool = False, device=None) -> dict:
    dev = init_device(gen, device)
    p = {"ln": norm_init(norm, d, dev)}
    p["w1"] = linear_init(gen, d, d_ff, use_bias=use_bias, device=dev)
    if kind in GLU_KINDS:
        p["w3"] = linear_init(gen, d, d_ff, use_bias=use_bias, device=dev)
    p["w2"] = linear_init(gen, d_ff, d, use_bias=use_bias, device=dev)
    return p


def ffn_specs(kind: str, norm: str, use_bias: bool = False) -> dict:
    """Logical axes of :func:`ffn_init`'s leaves (the reference's)."""
    s = {"ln": norm_specs(norm),
         "w1": linear_specs("embed", "mlp", use_bias=use_bias)}
    if kind in GLU_KINDS:
        s["w3"] = linear_specs("embed", "mlp", use_bias=use_bias)
    s["w2"] = linear_specs("mlp", "embed", use_bias=use_bias)
    return s


def ffn_apply(ctx: RunCtx, kind: str, norm: str, p: dict,
              x: torch.Tensor) -> torch.Tensor:
    """Pre-norm FFN sublayer with residual."""
    xn = norm_apply(norm, p["ln"], x)
    h = _act(kind, linear_apply(ctx, p["w1"], xn, name="w1"))
    if kind in GLU_KINDS:
        h = h * linear_apply(ctx, p["w3"], xn, name="w3")
    y = linear_apply(ctx, p["w2"], h, name="w2")
    return x + y.to(x.dtype)
