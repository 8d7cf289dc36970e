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

from repro_torch.core import mx as mxlib
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.layers import backends as backends_lib


# --------------------------------------------------------------- sharding

# logical axis -> mesh axis (or a tuple of them); the reference's table
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_seq": None,  # attention K/V sequence axis (SP when heads unshardable)
    "cache_seq": None,  # resident KV-cache sequence axis (flash-decoding)
    "state_heads": None,  # SSM/xLSTM state head axis
    "qkv_fused": None,
    "kv_fused": None,
    "heads_g": None,
    "exp_group": ("pod", "data"),  # grouped MoE dispatch (per DP shard)
    "exp_e": None,  # replicated expert axis around dispatch/combine
    "exp_cap": None,
    "conv": None,
    "state": None,
    "zero": None,
    "layers": None,
    "replicated": None,
}


@dataclasses.dataclass
class ShardingCtx:
    """Resolves logical axis names to mesh axes (the reference's
    ``ShardingCtx.resolve``). ``mesh`` is a ``launch.mesh.Mesh`` (its
    ``axis_names``), or None: nothing resolves. A resolved spec is a tuple
    with one entry a dim: a mesh axis name, a tuple of them, or None (the
    reference's ``PartitionSpec``, whose canonical form writes a tuple of
    one axis as the axis). The port applies no activation
    constraints: it runs one device's program (the dry-run counts it)."""

    mesh: Any = None
    rules: dict[str, Any] = dataclasses.field(default_factory=dict)

    def resolve(self, logical_axes) -> tuple:
        names = []
        used: set = set()
        for ax in logical_axes:
            r = self.rules.get(ax, DEFAULT_RULES.get(ax)) if ax else None
            if isinstance(r, (list, tuple)):
                r = tuple(a for a in r
                          if self.mesh and a in self.mesh.axis_names)
                r = tuple(a for a in r if a not in used) or None
            elif r is not None:
                if self.mesh is not None and r not in self.mesh.axis_names:
                    r = None
                if r in used:
                    r = None
            if r is not None:
                used.update(r if isinstance(r, tuple) else (r,))
            names.append(canonical_axes(r))
        return tuple(names)


def canonical_axes(entry):
    """A resolved entry as ``PartitionSpec`` writes it: a tuple of one
    mesh axis is that axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def spec_leaf(x) -> bool:
    """A logical spec: a tuple of axis names or None."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def init_device(gen: torch.Generator, device=None) -> torch.device:
    """Where a random init puts its tensors: ``device``, or ``gen``'s. On
    ``meta`` (shapes and dtypes only) a CPU ``gen`` serves: nothing is
    drawn, and no ``meta`` generator exists."""
    return gen.device if device is None else torch.device(device)


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
    # the model axis's communicator (distributed.collectives.AxisComm) of
    # the sharded train step on a model axis larger than 1: the layers'
    # weights are this rank's model shards and they run tensor-parallel
    # (heads, mlp and vocab over the model ranks). None on one device.
    # The sharded serving steps set it too.
    tp: Any = None
    # the sharded serving steps' cut cache sequence: one
    # distributed.seq_parallel.SeqShard (or None: whole) a segment
    # (``seq_shards``, set by the step), and the segment's own (``seq``,
    # set by models.lm.forward for each segment's layers)
    seq_shards: Any = None
    seq: Any = None

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
                use_bias: bool = False, device=None) -> dict:
    """N(0, 1/k) weights [K, N] (f32), optional zero bias, on ``device``
    (default ``gen``'s; ``meta`` draws nothing from a CPU ``gen``)."""
    scale = (1.0 / k) ** 0.5
    dev = init_device(gen, device)
    w = torch.randn((k, n), generator=gen, dtype=torch.float32, device=dev)
    params = {"w": w.mul_(scale)}
    if use_bias:
        params["b"] = torch.zeros((n,), dtype=torch.float32, device=dev)
    return params


def linear_specs(in_axis: str = "embed", out_axis: str = "mlp", *,
                 use_bias: bool = False) -> dict:
    """Logical axes of :func:`linear_init`'s leaves (the reference's)."""
    specs = {"w": (in_axis, out_axis)}
    if use_bias:
        specs["b"] = (out_axis,)
    return specs


def linear_apply(ctx: RunCtx, params: dict, x: torch.Tensor,
                 name: str | None = None) -> torch.Tensor:
    """Backend-dispatched linear, x [..., K] (bf16). Converted-param
    markers win, otherwise ``ctx.quant`` names the backend. ``name`` is the
    call site's param key; with an active tap it extends ``ctx.scope`` into
    the param-tree path that keys Row-Hist calibration; with an active
    fidelity probe the linear's input is probed under the same path.
    Under tensor parallelism (``ctx.tp``) it is a column-parallel linear
    (its ``w`` the rank's output columns)."""
    if ctx.tap is not None and name is not None:
        path = f"{ctx.scope}/{name}" if ctx.scope else name
        ctx.tap.record(path, params, x)
    if ctx.tp is not None:
        return _column_linear(ctx, params, x)
    if ctx.fidelity is not None and name is not None:
        path = f"{ctx.scope}/{name}" if ctx.scope else name
        ctx.fidelity.observe_linear(path, ctx, params, x)
    y = backends_lib.resolve_backend(ctx, params).forward(ctx, params, x)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _tp_backend(ctx: RunCtx, params: dict) -> backends_lib.LinearBackend:
    """The backend of a tensor-parallel linear: one that takes ``matmul``
    and ``quant`` (``tensor_parallel``: the train step's) or one with a
    row-parallel form of its own (``serve_parallel``: the serving steps';
    ``launch.steps.check_model_axis`` admits no other). A tap or a
    fidelity probe would see one rank's shard."""
    if ctx.tap is not None or ctx.fidelity is not None:
        raise NotImplementedError("a tap or a fidelity probe under tensor "
                                  "parallelism")
    backend = backends_lib.resolve_backend(ctx, params)
    if not (backend.tensor_parallel or backend.serve_parallel):
        raise NotImplementedError(f"backend {backend.name!r} under tensor "
                                  "parallelism; see ROADMAP.md")
    return backend


def _column_linear(ctx: RunCtx, params: dict, x: torch.Tensor
                   ) -> torch.Tensor:
    """A column-parallel linear under ``ctx.tp``: the backend's product on
    the rank's columns, in bf16 as on one device. ``x`` is replicated over
    the model ranks; its gradient is this linear's, each rank's part
    taken in f32 (``tensor_parallel.matmul_bf16``), summed over the ranks
    in f32 and cast to ``x``'s dtype once (``copy_to_model``): the
    one-device product's gradient, rounded as that one is, before
    autograd adds the linears' gradients of a shared input as it does on
    one device. A serving backend (``serve_parallel``) runs its own
    product on the rank's columns (packed ``codes`` / ``exps`` of kernel
    C, or kernel A's K-major ones), as on one device."""
    backend = _tp_backend(ctx, params)
    if backend.tensor_parallel:
        xf = tpl.copy_to_model(x.to(torch.float32), ctx.tp)
        y = backend.forward(ctx, params, xf, matmul=tpl.matmul_bf16)
    else:
        y = backend.forward(ctx, params, x)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def row_linear_apply(ctx: RunCtx, params: dict, x: torch.Tensor,
                     name: str | None = None) -> torch.Tensor:
    """:func:`linear_apply` of a row-parallel linear (``wo``, ``w2``: K
    over the model axis). On one device (``ctx.tp`` None) it is
    :func:`linear_apply`. Under ``ctx.tp`` ``x`` holds this rank's K
    columns and ``params["w"]`` its K rows: each rank's partial product
    is taken in f32, the ranks' partials summed in f32 and cast to bf16
    once (as the one-device product rounds once), then the bias, once.
    A backend's activation quant runs along the whole row's 32-blocks
    (``tensor_parallel.fake_quant_cut``). A serving backend runs its own
    row-parallel form (``LinearBackend.forward_row``: kernel C's f32
    partials, kernel A's integer pass sums before the one read-out)."""
    tp = ctx.tp
    if tp is None:
        return linear_apply(ctx, params, x, name=name)

    def matmul(a, w):
        part = tpl.matmul_f32(a.to(torch.bfloat16), w)
        return tpl.reduce_from_model(part, tp).to(torch.bfloat16)

    backend = _tp_backend(ctx, params)
    if backend.tensor_parallel:
        y = backend.forward(ctx, params, x, matmul=matmul,
                            quant=lambda a: tpl.fake_quant_cut(a, -1, tp))
    else:
        y = backend.forward_row(ctx, params, x, tp)
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


def norm_specs(kind: str) -> dict:
    """Logical axes of :func:`norm_init`'s leaves."""
    if kind == "rmsnorm":
        return {"gamma": ("embed",)}
    return {"gamma": ("embed",), "beta": ("embed",)}


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm_apply(params, x)
    return layernorm_apply(params, x)


# ------------------------------------------------------------- embeddings

def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> dict:
    emb = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                      device=init_device(gen, device))
    return {"emb": emb.mul_(d ** -0.5)}


EMBED_SPECS = {"emb": ("vocab", "embed")}


def embed_apply(params: dict, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """The bf16 rows of ``ids``. Under ``tp`` (the model axis) the table
    holds this rank's vocab rows: ids outside them give zero rows, and
    the sum over the model ranks is the lookup, exactly (one rank holds
    each row)."""
    emb = params["emb"].to(torch.bfloat16)
    if tp is None:
        return emb[ids]
    rows = emb.shape[0]
    local = ids - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = emb[torch.where(mine, local, torch.zeros_like(local))]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return tpl.reduce_from_model(x, tp)


# ------------------------------------------------ training: prequant

def _on_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple) and "model" in entry)


def quantize_weights_tree(tree, ndims, tp=None, specs=None):
    """Step-boundary weight fake-quant for training ("prequant"): the
    per-linear fake-quant of ``mxfp4_ste`` hoisted out of the microbatch
    loop, exact because the weights are constant within a step. Each
    linear ``w`` and each expert bank ``w1`` / ``w2`` / ``w3`` with a
    32-aligned contraction dim is fake-quantized along it (STE) to bf16;
    every other float32 leaf of two or more dims goes to bf16; the rest
    stays as it is. Differentiable: the gradient into the f32 params is
    the identity, cast to f32.

    ``ndims`` is a tree of the same structure holding each leaf's ndim in
    the reference's tree (``models.lm.ref_ndim_tree``), which stacks a
    segment's layers only when it has more than one: a stacked norm gamma
    or bias has two dims there and is cast to bf16, a single-layer one
    stays f32. The rules read that ndim, not the port's.

    Under ``tp`` (the model axis) the leaves are this rank's model shards
    and ``specs`` (their resolved specs, the tree's layout) say which are
    cut over ``model``: the contraction dim's length and its 32-blocks are
    the whole leaf's, and a row-parallel ``w`` (``wo``, ``w2``: K over
    ``model``) whose K shard is not a whole number of blocks is gathered
    over the model ranks, quantized and cut again
    (``tensor_parallel.fake_quant_cut``). Each rank's quantized shard is
    bitwise that shard of the one-device quant."""

    def quant(v, spec):
        cut = tp is not None and spec is not None and _on_model(spec[-2])
        k = v.shape[-2] * (tp.size if cut else 1)
        if k % mxlib.BLOCK:
            return None
        return tpl.fake_quant_cut(v, -2, tp if cut else None).to(
            torch.bfloat16)

    def rec(node, nd, sp):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                spk = sp[k] if sp is not None else None
                q = None
                if (k == "w" and nd[k] in (2, 3)) or (
                        k in ("w1", "w2", "w3") and nd[k] in (3, 4)):
                    q = quant(v, spk)
                out[k] = q if q is not None else rec(v, nd[k], spk)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, n, sp[i] if sp is not None else None)
                              for i, (v, n) in enumerate(zip(node, nd)))
        if torch.is_tensor(node) and node.dtype == torch.float32 and nd >= 2:
            return node.to(torch.bfloat16)
        return node

    return rec(tree, ndims, specs)


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


def convert_specs_mxfp4(specs, params, min_n: int = 256):
    """:func:`convert_params_mxfp4` on the logical spec tree: a packed
    linear's ``codes`` and ``exps`` and a packed expert bank's take the
    float weight's axes; ``params`` is the tree before conversion (its
    shapes decide, as there). The reference's ``convert_specs_mxfp4``,
    over the port's tree of one dict a layer (the MoE router stays
    unpacked, as :func:`convert_params_mxfp4` keeps it)."""

    def rec(spec, node, key=""):
        if isinstance(spec, dict):
            w = node.get("w")
            if (key != "router" and w is not None and w.ndim == 2
                    and w.shape[0] % 32 == 0 and w.shape[1] >= min_n):
                out = {"codes": spec["w"], "exps": spec["w"]}
                out.update({k: v if k == "b" else rec(v, node[k], k)
                            for k, v in spec.items() if k != "w"})
                return out
            return {k: {"codes": v, "exps": v}
                    if backends_lib.is_expert_bank(k, node[k])
                    else rec(v, node[k], k) for k, v in spec.items()}
        if isinstance(spec, list):
            return [rec(v, n, key) for v, n in zip(spec, node)]
        return spec

    return rec(specs, params)


def convert_specs_cim(specs, tree):
    """The logical spec tree of a served tree ``tree``: a
    ``cim_analog``-converted linear's ``codes`` and ``exps`` (K-major
    [K, N] and [K/32, N]) take the float weight's axes and its ``e_n`` /
    ``adc_fs`` are replicated (``()``); a packed (``mxfp4_wonly``) node or
    expert bank maps as :func:`convert_specs_mxfp4` maps it; every other
    leaf keeps its spec. ``tree`` is the converted tree itself (which
    linears were calibrated decides, not their shapes)."""

    def packed(v):
        return isinstance(v, dict) and "codes" in v

    def rec(spec, node):
        if isinstance(spec, dict):
            if "w" in spec and packed(node):
                out = {"codes": spec["w"], "exps": spec["w"]}
                if "e_n" in node:
                    out.update(e_n=(), adc_fs=())
                if "b" in node:
                    out["b"] = spec["b"]
                return out
            return {k: {"codes": v, "exps": v}
                    if spec_leaf(v) and packed(node[k]) else rec(v, node[k])
                    for k, v in spec.items()}
        if isinstance(spec, list):
            return [rec(v, n) for v, n in zip(spec, node)]
        return spec

    return rec(specs, tree)

