"""Sort-based top-k Mixture-of-Experts (Mixtral / Qwen3-MoE style),
counterpart of ``repro.layers.moe`` with one dispatch group (the
reference's ``_n_groups`` is 1 without a device mesh).

Tokens are routed by an f32 router (softmax, top-k, renormalised gates)
and dispatched into a static per-expert capacity ``cap = max(1,
ceil(T·k·cf / E))``: a stable sort of the flat expert ids, each expert's
first slot by ``searchsorted``, and the tokens past ``cap`` dropped. Every
routed row takes capacity, padded prefill rows and idle decode lanes
included, as in the reference, so whether a live token is dropped depends
on its step's batch.

Dispatch and combine are gathers through index maps, with no atomic
adds, so a step is deterministic and captured == eager holds bitwise:
each slot of the ``[E, cap, d]`` buffer gathers its source row (an empty
slot is zero), and each token sums its k gated contributions in ascending
expert order by sequential adds from zero in ``x.dtype``, the order in
which the reference's scatter-add applies them.

The expert products of a packed bank run on the ``mxfp4_matmul`` kernel
on CUDA under ``impl="auto"``: each expert's ``[cap, K]`` rows against its
``[K//2, N]`` slice of the bank, the kernel's resident format, ``3E``
launches a layer (``2E`` without a GLU). Capacity is static, so every
expert launches on every step. The plain version (CPU tensors, a float
bank, ``impl="ref"``) is the reference's composition: the whole bank
dequantized to bf16 (``backends.expert_weight``), then one einsum.
"""

from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib
from repro_torch.kernels.mxfp4_matmul import ops as mm_ops
from repro_torch.layers import backends
from repro_torch.layers.common import (
    RunCtx,
    linear_init,
    norm_apply,
    norm_init,
)
from repro_torch.layers.ffn import GLU_KINDS, _act

_STE = ("mxfp4_ste", "mxfp4_ste_prequant")


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             kind: str, norm: str) -> dict:
    """The norm, the router [d, E] and the expert banks ``w1`` (and
    ``w3`` for a GLU) [E, d, d_ff] and ``w2`` [E, d_ff, d], f32."""
    dev = gen.device

    def bank(k: int, n: int) -> torch.Tensor:
        w = torch.randn((n_experts, k, n), generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_((1.0 / k) ** 0.5)

    p = {"ln": norm_init(norm, d, dev),
         "router": linear_init(gen, d, n_experts),
         "w1": bank(d, d_ff)}
    if kind in GLU_KINDS:
        p["w3"] = bank(d, d_ff)
    p["w2"] = bank(d_ff, d)
    return p


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert takes in one dispatch group of ``tokens`` rows, as
    the reference computes it (a float ceiling)."""
    return int(max(1, -(-tokens * top_k * capacity_factor // n_experts)))


def route(xn: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(gate f32 [T, k], idx int64 [T, k]): the f32 router's softmax, its
    top k (ties to the lower expert id, as ``lax.top_k``) and the gates
    renormalised over them. TF32 would round the router's inputs and flip
    choices, so it must be off on CUDA."""
    if xn.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("moe router: TF32 matmuls are on; the router's "
                           "f32 logits need them off")
    logits = xn.to(torch.float32) @ router_w.to(torch.float32)
    u = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = u / u.sum(-1, keepdim=True)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :top_k], order[:, :top_k]
    return gate / gate.sum(-1, keepdim=True), idx


def expert_matmul(ctx: RunCtx, h: torch.Tensor, bank) -> torch.Tensor:
    """[E, cap, K] @ each expert's [K, N] -> [E, cap, N]. A packed bank on
    CUDA under ``impl="auto"`` launches the ``mxfp4_matmul`` kernel once an
    expert; otherwise the reference's composition (the bank resolved by
    ``backends.expert_weight``, one einsum)."""
    if isinstance(bank, dict) and h.is_cuda and ctx.impl == "auto":
        return torch.stack([
            mm_ops.mxfp4_matmul(h[i], bank["codes"][i], bank["exps"][i],
                                obs=ctx.obs)
            for i in range(h.shape[0])])
    w = backends.expert_weight(ctx, bank)
    # bf16 operands with f32 accumulation, as f32 products of the exactly
    # bf16-valued operands rounded once: XLA's CPU einsum, bitwise (a bf16
    # torch einsum differs from it in the last bit now and then)
    out = torch.einsum("ecd,edf->ecf", h.to(torch.float32),
                       w.to(torch.float32))
    return out.to(torch.promote_types(h.dtype, w.dtype))


def moe_apply(ctx: RunCtx, kind: str, norm: str, p: dict, x: torch.Tensor,
              top_k: int, capacity_factor: float = 1.25) -> torch.Tensor:
    """Pre-norm MoE sublayer with its residual; x [B, S, d]."""
    b, s, d = x.shape
    e = p["router"]["w"].shape[-1]
    t = b * s
    dev = x.device
    xn = norm_apply(norm, p["ln"], x).reshape(t, d)
    if ctx.quant in _STE:
        xn = mxlib.fake_quant(xn)
    gate, idx = route(xn, p["router"]["w"], top_k)
    cap = capacity(t, top_k, e, capacity_factor)

    fe = idx.reshape(t * top_k)
    order = torch.argsort(fe, stable=True)  # sorted position -> flat pair
    se = fe[order]
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(se, experts, right=False)
    counts = torch.searchsorted(se, experts, right=True) - starts
    # dispatch: slot (expert, c) takes sorted position starts + c
    slot = torch.arange(cap, device=dev)
    filled = slot[None] < counts[:, None]  # [E, cap]
    pos = (starts[:, None] + slot[None]).clamp(max=t * top_k - 1)
    src = order[pos] // top_k
    buf = torch.where(filled[..., None], xn[src],
                      torch.zeros((), dtype=xn.dtype, device=dev))

    h = _act(kind, expert_matmul(ctx, buf, p["w1"]))
    if kind in GLU_KINDS:
        h = h * expert_matmul(ctx, buf, p["w3"])
    if ctx.quant in _STE:
        h = mxlib.fake_quant(h)
    out_buf = expert_matmul(ctx, h, p["w2"]).reshape(e * cap, d)

    # combine: each (token, choice) pair reads its slot, or 0 if dropped
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * top_k, device=dev))
    pos_in_e = inv - starts[fe]
    keep = pos_in_e < cap
    dest = (fe * cap + pos_in_e).clamp(max=e * cap - 1)
    gathered = torch.where(keep[:, None], out_buf[dest],
                           torch.zeros((), dtype=out_buf.dtype, device=dev))
    contrib = (gathered * gate.reshape(t * top_k, 1).to(gathered.dtype)
               ).to(x.dtype).reshape(t, top_k, d)
    rank = torch.argsort(idx, dim=-1)  # a token's choices by expert id
    contrib = torch.gather(contrib, 1, rank[..., None].expand(t, top_k, d))
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for i in range(top_k):
        y = y + contrib[:, i]
    return x + y.reshape(b, s, d)
