"""Static partition of a layer stack over pipeline stages or chips: the
reference's ``repro.distributed.sharding.stage_partition``, copied (that
module imports JAX; the port takes this function and nothing else)."""

from __future__ import annotations


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
