"""Logical-axis sharding rules (counterpart of the reference's
``repro.distributed.sharding``): the per-(arch, mesh, mode) rule tables,
their resolution into per-dim mesh axes, ZeRO's optimizer-state specs and
the static stage partition of a layer stack.

The reference resolves specs into ``NamedSharding``s for XLA's GSPMD
partitioner. The port resolves them into plain tuples (one entry a dim: a
mesh axis, a tuple of them, or None) and, with :func:`shard_shape`, into
each device's shard shape: what the dry-run needs to count the bytes a
device holds. No step here runs sharded (``ROADMAP.md``)."""

from __future__ import annotations

from repro_torch.layers.common import (
    DEFAULT_RULES,
    ShardingCtx,
    canonical_axes,
    spec_leaf,
)


def make_rules(cfg, mesh, mode: str = "train",
               batch_size: int | None = None) -> dict:
    """mode: train | prefill | decode (the reference's table)."""
    axes = mesh.axis_names
    mdl = mesh.shape["model"] if "model" in axes else 1
    model = "model" if "model" in axes else None
    data_axes = tuple(a for a in ("pod", "data") if a in axes)

    def div(n):
        return model if (n % mdl == 0 and n >= mdl) else None

    heads_shardable = cfg.n_heads % mdl == 0 and cfg.n_heads >= mdl

    rules = dict(DEFAULT_RULES)
    rules.update(
        batch=data_axes,
        seq=None,
        embed=None,
        layers=None,
        vocab=div(cfg.vocab_size),
        qkv_fused=div(cfg.n_heads * cfg.hd),
        kv_fused=div(cfg.n_kv_heads * cfg.hd),
        mlp=model,
        heads=model if heads_shardable else None,
        heads_g=None,
        head_dim=None,
        kv_heads=div(cfg.n_kv_heads),
        experts=model if cfg.moe_shard == "ep" else None,
        expert_mlp=model if cfg.moe_shard == "tp" else None,
        exp_group=data_axes,  # grouped MoE dispatch (per DP shard)
        exp_cap=None,
        kv_seq=None,
        cache_seq=None,
        state_heads=model,  # SSM/xLSTM state heads (divisibility-gated)
    )
    if mode == "decode":
        # flash-decoding: the resident KV cache's sequence axis over
        # `model` (+`data` when the batch is too small to fill it)
        cache_axes = (("data", "model")
                      if batch_size is not None and batch_size < 16
                      else model)
        rules.update(kv_seq=model, cache_seq=cache_axes, heads=None,
                     kv_heads=None)
    elif mode == "prefill":
        rules.update(cache_seq=model)
        if not heads_shardable:
            rules.update(kv_seq=model)
    elif not heads_shardable:
        # sequence-parallel attention for head counts not divisible by TP
        rules.update(kv_seq=model)
    return rules


def make_ctx(cfg, mesh, mode: str = "train",
             batch_size: int | None = None) -> ShardingCtx:
    if mesh is None:
        return ShardingCtx()
    return ShardingCtx(mesh=mesh, rules=make_rules(cfg, mesh, mode,
                                                   batch_size))


def _map_specs(fn, specs, *trees):
    """``fn`` over the spec leaves of ``specs`` and the matching nodes of
    ``trees`` (dicts, lists and tuples that are not specs)."""
    if spec_leaf(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree node: {specs!r}")


def resolve_tree(specs, ctx: ShardingCtx):
    """Logical spec tree -> resolved spec tree (the reference's
    ``NamedSharding`` tree, as tuples)."""
    return _map_specs(ctx.resolve, specs)


def opt_state_specs(param_specs, cfg=None, mesh=None, zero1: bool = True):
    """AdamW m / v logical specs: the params', with ZeRO-1 sharding of the
    first usually-unsharded axis (None or ``embed``) over the data axis,
    through the ``zero`` logical axis."""
    if not zero1:
        return param_specs

    def z(spec):
        out = list(spec)
        for i, a in enumerate(out):
            if a in (None, "embed"):
                out[i] = "zero"
                break
        return tuple(out)

    return _map_specs(z, param_specs)


def zero_rules(rules: dict, mesh, enabled: bool = True) -> dict:
    r = dict(rules)
    r["zero"] = "data" if (enabled and "data" in mesh.axis_names) else None
    return r


def resolve_with_divisibility(specs, shapes, ctx: ShardingCtx, mesh):
    """Resolve specs against the shapes of ``shapes`` (tensors, or anything
    with a ``shape``), dropping mesh axes whose size does not divide the
    dim (ZeRO on odd shapes); a tree of resolved tuples."""

    def one(spec, t):
        names = []
        used: set = set()
        for i, ax in enumerate(spec):
            r = ctx.rules.get(ax, DEFAULT_RULES.get(ax)) if ax else None
            cand = r if isinstance(r, (list, tuple)) else ((r,) if r else ())
            picked = []
            sz = 1
            for a in cand:
                if a is None or a not in mesh.axis_names or a in used:
                    continue
                if t.shape[i] % (sz * mesh.shape[a]) != 0:
                    continue  # dropped axes must NOT consume `used`
                picked.append(a)
                sz *= mesh.shape[a]
            used.update(picked)
            names.append(canonical_axes(tuple(picked)) if picked else None)
        return tuple(names)

    return _map_specs(one, specs, shapes)


def shard_shape(spec: tuple, shape, mesh) -> tuple:
    """One device's shard of a tensor of ``shape`` under the resolved
    ``spec`` (what ``NamedSharding(mesh, spec).shard_shape`` gives in the
    reference): each dim divided, rounding up, by the product of its mesh
    axes' sizes; dims past the spec are whole."""
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        k = 1
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            k *= mesh.shape[a]
        out.append(-(-n // k))
    return tuple(out)


def stage_partition(
    n_layers: int,
    n_chips: int,
    mode: str = "equal",
    costs: list | None = None,
) -> list[tuple[int, int]]:
    """Contiguous split of a layer-stacked trunk over pipeline stages/chips:
    ``[(lo, hi), ...)`` half-open layer ranges.

    ``mode="equal"`` (default) splits by layer count, earlier chips taking
    the remainder (vit-l32 / bert-large: 24 layers, 2 chips ->
    [(0, 12), (12, 24)] — the paper's §5.3 dual-chip FWS deployment).

    ``mode="balanced"`` takes per-layer ``costs`` (e.g. from the
    reference's ``distributed.blockwise.serve_layer_costs``) and minimizes
    the bottleneck stage cost over all contiguous partitions (the quantity
    that bounds steady-state pipeline throughput), tie-broken by the sum of
    squared stage costs so equally-bottlenecked cuts prefer flatter loads.
    With no ``costs`` it falls back to the equal split (uniform costs).

    This is the serving-time analogue of mesh sharding rules: instead of
    sharding one op over devices, whole blocks are pinned per chip (fully
    weight-stationary — weights never move, activations hop)."""
    if not 1 <= n_chips <= n_layers:
        raise ValueError(f"need 1 <= n_chips ({n_chips}) <= n_layers "
                         f"({n_layers})")
    if mode not in ("equal", "balanced"):
        raise ValueError(f"unknown stage_partition mode {mode!r}")
    if mode == "balanced" and costs is not None:
        if len(costs) != n_layers:
            raise ValueError(
                f"costs has {len(costs)} entries for {n_layers} layers"
            )
        return _balanced_partition([float(c) for c in costs], n_chips)
    base, rem = divmod(n_layers, n_chips)
    bounds = []
    lo = 0
    for c in range(n_chips):
        hi = lo + base + (1 if c < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _balanced_partition(costs: list, k: int) -> list[tuple[int, int]]:
    """Min-bottleneck contiguous k-partition by dynamic programming
    (O(k n^2), exact): every stage gets >= 1 layer."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    # best[s][i]: (bottleneck, sum-of-squares) of the first i layers over s
    # stages; cut[s][i] reconstructs the last stage's start
    best = [[(inf, inf)] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    best[0][0] = (0.0, 0.0)
    for s in range(1, k + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                lo_b, lo_sq = best[s - 1][j]
                if lo_b == inf:
                    continue
                c = prefix[i] - prefix[j]
                cand = (max(lo_b, c), lo_sq + c * c)
                if cand < best[s][i]:
                    best[s][i] = cand
                    cut[s][i] = j
    bounds = []
    i = n
    for s in range(k, 0, -1):
        j = cut[s][i]
        bounds.append((j, i))
        i = j
    return bounds[::-1]
