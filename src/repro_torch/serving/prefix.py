"""Radix prefix cache over the paged KV pool (counterpart of
``repro.serving.prefix``).

Shared system prompts open most requests, so the engine reuses their KV
rows page by page instead of recomputing them:

* The tree is a token-chunk radix tree, one edge per ``chunk_len`` prompt
  tokens, the engine's chunked-prefill grid. A node at depth ``d`` names
  the page of some past request whose first ``d*L`` tokens equal the
  node's path and offers its first ``d*L`` KV rows.
* Slots are shared through the refcounts of ``SlotAllocator``: the cache
  holds one reference per slot it advertises, the engine one per request
  in flight. A page is evictable when the cache is its sole owner
  (refcount 1), so an LRU eviction never pulls a page from a live lane.
* A hit is copy-on-write at admission: the engine copies the matched rows
  into the request's own page (``kvcache.clone_prefix``) before its first
  suffix chunk runs.
* Page identity is content-addressed: a node carries a SHA-1 of the donor
  page's prefix rows (raw K/V and, where the pool has them, the quantized
  mirrors), and the engine re-hashes the donor at match time. Changed
  bytes under an advertised page become a counted miss, never wrong KV.

Reuse rests on causality: row ``i`` of a page depends only on prompt
tokens ``<= i``, pages are zeroed past the copied prefix at admission,
and the first suffix chunk recomputes the mirrors for the whole page, so
a cache-on pool is bitwise a cache-off one. A V 32-block straddling the
prefix edge shares its exponent with donor rows past the prefix, so the
fingerprints cover only whole V blocks inside it (K codes and raw rows
are per position and cover the tail).
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np
import torch

from repro_torch.core.mx import BLOCK

_NP_DTYPE = {torch.bfloat16: np.int16}  # numpy has no bf16: hash its bits


def page_rows(kv, slot: int) -> dict:
    """Page ``slot`` of every leaf, on the host, in one device-to-host
    transfer: {(segment, layer, leaf name): numpy array}. Fingerprints of
    several depths are hashed from this one copy."""
    keys, parts = [], []
    for si, (seg_pool, spec) in enumerate(zip(kv.pool, kv.specs)):
        for li, layer in enumerate(seg_pool):
            for name in sorted(layer):
                row = layer[name].select(spec[name].index("batch"), slot)
                keys.append((si, li, name, row.dtype, tuple(row.shape)))
                parts.append(row.contiguous().reshape(-1).view(torch.uint8))
    flat = torch.cat(parts).cpu().numpy()
    out, at = {}, 0
    for (si, li, name, dtype, shape), part in zip(keys, parts):
        n = part.numel()
        np_dtype = _NP_DTYPE.get(dtype) or torch.empty(
            (), dtype=dtype).numpy().dtype
        out[(si, li, name)] = flat[at:at + n].view(np_dtype).reshape(shape)
        at += n
    return out


def rows_fingerprint(kv, rows: dict, n: int) -> bytes:
    """SHA-1 over the prefix-determined bytes of the first ``n`` rows of a
    host page copy (:func:`page_rows`): every leaf's prefix slice, with the
    blockwise V codes and exponents cut to whole 32-blocks. The header
    names the pool's layout, as the reference's does."""
    h = hashlib.sha1()
    h.update(struct.pack("<iii", n, kv.page_len, int(kv.fused)))
    nb = (n // BLOCK) * BLOCK
    for si, (seg_pool, spec) in enumerate(zip(kv.pool, kv.specs)):
        for li, layer in enumerate(seg_pool):
            for name in sorted(layer):
                arr = rows[(si, li, name)]
                ax = spec[name].index("batch")
                sub = spec[name][:ax] + spec[name][ax + 1:]
                if name == "v_exps":
                    # one exponent a 32-block of keys: legacy [Hkv, Dh,
                    # Wpad/32] (block axis last), fused [ceil(W/32), Hkv,
                    # Dh] (block axis first)
                    parts = [np.take(arr, np.arange(n // BLOCK),
                                     axis=0 if kv.fused else arr.ndim - 1)]
                elif name == "v_codes":  # legacy [Hkv, Dh, Wpad]
                    parts = [np.take(arr, np.arange(nb),
                                     axis=sub.index("cache_seq"))]
                elif name == "kv_codes":
                    # [W, 2Hkv, Dpad/2]: even head rows are K codes (per
                    # position, to n), odd ones V codes (whole blocks only)
                    parts = [arr[:n, 0::2], arr[:nb, 1::2]]
                else:  # k, v, kv, k_codes, k_exps: per position
                    parts = [np.take(arr, np.arange(n),
                                     axis=sub.index("cache_seq"))]
                h.update(name.encode())
                for p in parts:
                    p = np.ascontiguousarray(p)
                    h.update(struct.pack("<i", p.ndim))
                    h.update(np.asarray(p.shape, np.int64).tobytes())
                    h.update(p.tobytes())
    return h.digest()


def page_fingerprint(kv, slot: int, n: int) -> bytes:
    """One-shot fingerprint of rows ``[0, n)`` of page ``slot``."""
    return rows_fingerprint(kv, page_rows(kv, slot), n)


class _Node:
    __slots__ = ("children", "slot", "fp", "depth", "last_used")

    def __init__(self, depth: int):
        self.children: dict[tuple, _Node] = {}
        self.slot: int | None = None  # backing page, None = tombstone
        self.fp: bytes | None = None
        self.depth = depth
        self.last_used = 0


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    n_tokens: int  # chunk-aligned matched prefix length
    slot: int  # donor page to clone from


class PrefixCache:
    """Token-chunk radix tree mapping shared prompt prefixes to refcounted
    page slots; a host-side control plane (the engine copies the pages).
    ``fingerprints=False`` turns content hashing off (control-plane tests
    without a KV pool)."""

    def __init__(self, chunk_len: int, allocator, obs=None,
                 fingerprints: bool = True):
        if chunk_len < 1:
            raise ValueError("chunk_len must be >= 1")
        self.chunk_len = chunk_len
        self.allocator = allocator
        self.obs = obs
        self.fingerprints = fingerprints
        self.root = _Node(0)
        self._tick = 0
        # slot -> nodes advertising it; the cache holds ONE allocator
        # reference per slot in this map
        self._slots: dict[int, set[_Node]] = {}
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.verify_failures = 0
        self.inserted = 0

    # ------------------------------------------------------------ helpers

    def _count(self, name: str, by: int = 1) -> None:
        if self.obs is not None and self.obs.enabled:
            self.obs.registry.counter(
                f"serve_prefix_{name}_total",
                f"prefix cache {name.replace('_', ' ')}").inc(by)

    def _chunks(self, prompt, depth: int):
        L = self.chunk_len
        return tuple(prompt[(depth - 1) * L:depth * L])

    def _drop_slot(self, slot: int) -> None:
        """Forget every node backed by ``slot`` and release the cache's
        reference (tombstones keep deeper nodes reachable)."""
        for node in self._slots.pop(slot, ()):
            node.slot = None
            node.fp = None
        self.allocator.release(slot)

    # ------------------------------------------------------------ queries

    @property
    def cached_slots(self) -> set[int]:
        return set(self._slots)

    @property
    def n_evictable(self) -> int:
        """Cached pages no live request also holds (refcount 1)."""
        return sum(1 for s in self._slots if self.allocator.refcount(s) == 1)

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "verify_failures": self.verify_failures,
            "inserted": self.inserted,
            "cached_slots": len(self._slots),
        }

    # ----------------------------------------------------------- mutation

    def match(self, prompt, kv=None) -> PrefixHit | None:
        """Longest chunk-aligned cached prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens so that a live suffix chunk emits the
        first token (and rebuilds the page's mirrors). The donor page's
        fingerprint is verified before a hit is declared."""
        self._tick += 1
        max_depth = (len(prompt) - 1) // self.chunk_len
        node, best = self.root, None
        for d in range(1, max_depth + 1):
            node = node.children.get(self._chunks(prompt, d))
            if node is None:
                break
            if node.slot is not None:
                best = node
        if best is None:
            self.misses += 1
            self._count("misses")
            return None
        if self.fingerprints and kv is not None:
            fp = page_fingerprint(kv, best.slot, best.depth * self.chunk_len)
            if fp != best.fp:
                # the bytes under the advertised page changed: an
                # integrity failure, not a routine miss; drop the slot
                self.verify_failures += 1
                self.misses += 1
                self._count("verify_failures")
                self._count("misses")
                self._drop_slot(best.slot)
                return None
        best.last_used = self._tick
        n = best.depth * self.chunk_len
        self.hits += 1
        self.hit_tokens += n
        self._count("hits")
        self._count("hit_tokens", n)
        return PrefixHit(n_tokens=n, slot=best.slot)

    def insert(self, prompt, slot: int, kv=None) -> bool:
        """Offer a freshly prefilled page. Nodes are made for every full
        chunk of ``prompt``; nodes that already advertise a page keep it.
        Returns True if the cache adopted ``slot`` (and took an allocator
        reference on it)."""
        self._tick += 1
        max_depth = len(prompt) // self.chunk_len
        node, adopted = self.root, False
        rows = (page_rows(kv, slot)
                if self.fingerprints and kv is not None and max_depth else None)
        for d in range(1, max_depth + 1):
            key = self._chunks(prompt, d)
            child = node.children.get(key)
            if child is None:
                child = node.children[key] = _Node(d)
            if child.slot is None:
                child.slot = slot
                child.fp = (rows_fingerprint(kv, rows, d * self.chunk_len)
                            if rows is not None else None)
                if not adopted:
                    self.allocator.retain(slot)
                    adopted = True
                self._slots.setdefault(slot, set()).add(child)
            child.last_used = self._tick
            node = child
        if adopted:
            self.inserted += 1
            self._count("inserts")
        return adopted

    def evict_lru(self) -> bool:
        """Free the least recently used evictable page (refcount 1); its
        slot goes back on the allocator's free list. False when nothing
        is evictable."""
        victims = [(max(n.last_used for n in nodes), slot)
                   for slot, nodes in self._slots.items()
                   if self.allocator.refcount(slot) == 1]
        if not victims:
            return False
        _, slot = min(victims)
        self._drop_slot(slot)
        self.evictions += 1
        self._count("evictions")
        return True
