"""Slot-paged KV cache for continuous-batching decode (counterpart of
``repro.serving.kvcache``).

The pool is the per-segment, per-layer cache tree from ``lm.init_cache``,
allocated once with ``num_slots + lanes`` rows along the batch axis and
``page_len`` positions. Rows ``0 .. num_slots-1`` are request pages handed
out by :class:`SlotAllocator`; row ``num_slots + i`` is lane ``i``'s
scratch row, where an idle decode lane parks, so the lane -> row vector
is always injective. A pool is in one of the reference's two layouts:
``legacy`` (split ``{k, v}`` pages, gathered and scattered around each
decode step) or ``fused`` (head-interleaved pages decoded in place).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm


class PoolExhausted(RuntimeError):
    """Raised when a page slot is requested from an empty pool."""


@dataclasses.dataclass
class SlotAllocator:
    """Refcounted LIFO free-list over ``num_slots`` page slots (host side).
    A slot returns to the free list when its refcount drops to zero."""

    num_slots: int

    def __post_init__(self):
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> set[int]:
        return set(self._refs)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"no free KV page slots (num_slots="
                                f"{self.num_slots}, all referenced)")
        slot = self._free.pop()
        self._refs[slot] = 1
        return slot

    def try_alloc(self) -> int | None:
        return self.alloc() if self._free else None

    def retain(self, slot: int) -> None:
        if slot not in self._refs:
            raise ValueError(f"slot {slot} is not allocated")
        self._refs[slot] += 1

    def release(self, slot: int) -> None:
        if slot not in self._refs:
            raise ValueError(f"slot {slot} is not allocated")
        self._refs[slot] -= 1
        if self._refs[slot] == 0:
            del self._refs[slot]
            self._free.append(slot)

    free = release

    def refcount(self, slot: int) -> int:
        return self._refs.get(slot, 0)


def gather_rows(pool, specs, rows):
    """Cache rows ``rows`` out of the pool -> an R-row cache tree."""
    return [[{k: torch.index_select(v, spec[k].index("batch"), rows)
              for k, v in layer.items()} for layer in seg]
            for seg, spec in zip(pool, specs)]


def scatter_rows(pool, specs, rows, values) -> None:
    """Write an R-row cache tree into pool rows ``rows`` in place. Leaf
    dtypes must match: a lossy write raises instead of truncating."""
    for seg_pool, spec, seg_val in zip(pool, specs, values):
        for layer, vals in zip(seg_pool, seg_val):
            for k, v in layer.items():
                val = vals[k]
                if val.dtype != v.dtype:
                    raise TypeError(f"scatter_rows: {k}: {val.dtype} values "
                                    f"into a {v.dtype} pool leaf")
                v.index_copy_(spec[k].index("batch"), rows, val)


def clone_prefix(pool, specs, src_row, dst_row, n) -> None:
    """Copy the first ``n`` cache-sequence rows of page ``src_row`` into
    page ``dst_row`` in place and zero everything past them (the
    reference's ``clone_prefix``). With ``n == 0`` it resets the page: a
    reused slot carries stale rows, and one inside the active V 32-block
    would corrupt that block's shared exponent. With ``n > 0`` it is the
    prefix cache's copy-on-write at admission. Only the raw K/V rows
    (``kv``, or ``k`` and ``v``) are copied, bit-exactly; the quantized
    mirror leaves are zeroed, because the first suffix chunk recomputes
    them from the raw page before anything reads them.

    ``src_row``, ``dst_row`` and ``n`` are one-element int64 tensors on
    the pool's device. The copy is an ``arange(W) < n`` mask and index
    ops, so no shape depends on them and nothing reads them back to the
    host: the engine's clone step is one fixed CUDA graph."""
    src, dst = src_row.reshape(1), dst_row.reshape(1)
    for seg_pool, spec in zip(pool, specs):
        for layer in seg_pool:
            for name, v in layer.items():
                ax = spec[name].index("batch")
                if "cache_seq" in spec[name] and name in ("k", "v", "kv"):
                    sax = spec[name].index("cache_seq")
                    shape = [1] * v.ndim
                    shape[sax] = v.shape[sax]
                    keep = (torch.arange(v.shape[sax], device=v.device)
                            < n).reshape(shape)
                    row = torch.where(keep, v.index_select(ax, src),
                                      torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
                    v.index_copy_(ax, dst, row)
                else:
                    v.index_fill_(ax, dst, 0)


class PagedKVCache:
    """Fixed pool of KV pages + slot allocator for one served model, on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"`` is given). ``layout="legacy"`` allocates split
    ``{k, v}`` pages, which the engine gathers and scatters around each
    decode step; ``layout="fused"`` the head-interleaved pages that
    decode runs on in place (``RunCtx.paged_rows``). ``mx_digital`` pools
    carry the quantized-resident code mirrors, float pools carry none."""

    def __init__(self, cfg, num_slots: int, lanes: int, page_len: int,
                 mx_digital: bool = False, layout: str = "legacy",
                 device=None):
        if layout not in ("legacy", "fused"):
            raise ValueError(f"unknown KV layout {layout!r}")
        for seg in lm.build_segments(cfg):
            if seg.kind not in ("attn", "moe_attn"):
                raise NotImplementedError(
                    "paged serving requires attention-only segments "
                    f"(recurrent state can't take padded prefill): {seg.kind}")
            if seg.attn.window and seg.attn.window < page_len:
                raise NotImplementedError(
                    f"paged serving needs full pages (window "
                    f"{seg.attn.window} < page_len {page_len})")
        self.cfg = cfg
        self.num_slots = num_slots
        self.lanes = lanes
        self.page_len = page_len
        self.mx_digital = mx_digital
        self.layout = layout
        self.fused = layout == "fused"
        self.specs = lm.cache_specs(cfg, mx_digital=mx_digital,
                                    fused=self.fused)
        self.pool = lm.init_cache(cfg, num_slots + lanes, page_len,
                                  mx_digital=mx_digital, fused=self.fused,
                                  device=device)
        self.allocator = SlotAllocator(num_slots)

    def scratch_row(self, lane: int) -> int:
        return self.num_slots + lane

    @property
    def num_free(self) -> int:
        return self.allocator.num_free
