"""Continuous-batching inference engine (counterpart of
``repro.serving.engine``) on the fused paged KV pool.

Every step is fixed-shape, as in the reference:

  prefill  [1, prefill_len]   one padded prompt into its allocated slot
  chunk    [1, chunk_len]     one window of a longer prompt into its slot
                              (looped; lifts the prompt cap to page_len)
  decode   [lanes, 1]         one token per lane at per-lane positions

Prompts are right-padded with ``KV_PAD`` positions; idle decode lanes
park on their scratch rows and their outputs are dropped on the host.
Decode runs in place on the pool through ``RunCtx.paged_rows``: the
attention layers write the new K/V row and its mirrors straight into the
lanes' pool rows and run one ragged paged decode per layer.

Chunked prefill (``chunk_len``) feeds long prompts through the chunk step
one window at a time; under the ``chunked`` scheduler policy the windows
interleave with decode steps. Admission clones or resets the request's
page (``kvcache.clone_prefix``): with the prefix cache on
(``prefix_cache=True``) the longest chunk-aligned cached prefix is copied
from its donor page and only the suffix chunks run; on a miss the clone
zeroes the page, whose stale rows would otherwise corrupt the V blocks'
shared exponents of the quantized-resident mirrors.

``trace_report`` maps the recorded step events onto the FWS pipeline
model (``serving/pipeline.py``). Not ported yet (ROADMAP.md Queue 1): the
legacy split-page layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.layers import attention as attn_mod
from repro_torch.models import lm
from repro_torch.obs import Obs
from repro_torch.serving import pipeline as pipe_mod
from repro_torch.serving.kvcache import (
    PagedKVCache,
    PoolExhausted,
    clone_prefix,
    gather_rows,
    scatter_rows,
)
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    lanes: int = 4  # decode batch width
    num_slots: int = 6  # KV pages in the pool
    page_len: int = 48  # positions per page (prompt + generated)
    prefill_len: int = 16  # fixed prefill shape; prompts pad up to this
    policy: str = "prefill"  # admission policy (see scheduler.py)
    kv_layout: str = "fused"
    # chunked prefill: prompts run through a fixed [1, chunk_len] step in
    # absolute-position windows, lifting the prompt cap from prefill_len
    # to page_len (None: the single-shot padded prefill)
    chunk_len: int | None = None
    # radix prefix cache over the page pool (needs chunk_len: hits are
    # chunk-aligned so cached pages drop into the same chunk grid)
    prefix_cache: bool = False


class Engine:
    def __init__(self, params, cfg, ctx, ecfg: EngineConfig = EngineConfig(),
                 obs: Obs | None = None):
        if ecfg.prefill_len > ecfg.page_len:
            raise ValueError("prefill_len must fit in a page")
        if ecfg.chunk_len is not None and not (
                2 <= ecfg.chunk_len <= ecfg.page_len):
            # >= 2: the chunk step must take attention's multi-token
            # prefill branch, not the decode branch
            raise ValueError("chunk_len must be in [2, page_len]")
        if ecfg.prefix_cache and ecfg.chunk_len is None:
            raise ValueError("prefix_cache requires chunk_len (hits are "
                             "chunk-aligned)")
        self.params = params
        self.cfg = cfg
        self.ctx = ctx
        self.ecfg = ecfg
        self.device = params["embed"]["emb"].device  # the params' device
        self.obs = obs if obs is not None else Obs()
        self.kv = PagedKVCache(cfg, ecfg.num_slots, ecfg.lanes, ecfg.page_len,
                               mx_digital=ctx.hybrid_digital_sdpa,
                               layout=ecfg.kv_layout, device=self.device)
        self.sched = Scheduler(ecfg.lanes, ecfg.policy, obs=self.obs)
        self.prefix: PrefixCache | None = None
        if ecfg.prefix_cache:
            self.prefix = PrefixCache(ecfg.chunk_len, self.kv.allocator,
                                      obs=self.obs)
        self.requests: dict[int, Request] = {}
        self._next_rid = 0
        self._step_idx = 0

    # --------------------------------------------------------------- steps

    @torch.no_grad()
    def _prefill(self, ids, positions, row: int, last: int) -> int:
        cfg, ecfg = self.cfg, self.ecfg
        caches = lm.init_cache(cfg, 1, ecfg.page_len,
                               mx_digital=self.kv.mx_digital, fused=True,
                               device=self.device)
        # positions are arange(n) and a KV_PAD tail: the flash kernel's
        # layout (_run_prefill builds them so)
        ctx = dataclasses.replace(self.ctx, arange_positions=True)
        hidden, caches = lm.forward(
            self.params, cfg, ctx, {"ids": ids, "positions": positions},
            caches=caches, return_hidden=True)
        # head over the real last position only (padded tail discarded)
        logits = lm._head(self.ctx, cfg, self.params,
                          hidden[:, last][:, None])
        scatter_rows(self.kv.pool, self.kv.specs,
                     torch.tensor([row], device=self.device), caches)
        return int(torch.argmax(logits[0, 0].float()))

    @torch.no_grad()
    def _chunk(self, row: int, ids, positions, offset: int, last: int) -> int:
        """One [1, chunk_len] window of a longer prompt, written into the
        request's page at absolute positions (attention's chunked-prefill
        branch, selected by ``pos=offset``). The page was cloned or zeroed
        at admission, so rows past the written prefix are zeros."""
        rows = torch.tensor([row], device=self.device)
        caches = gather_rows(self.kv.pool, self.kv.specs, rows)
        hidden, caches = lm.forward(
            self.params, self.cfg, self.ctx,
            {"ids": ids, "positions": positions}, caches=caches, pos=offset,
            return_hidden=True)
        logits = lm._head(self.ctx, self.cfg, self.params,
                          hidden[:, last][:, None])
        scatter_rows(self.kv.pool, self.kv.specs, rows, caches)
        return int(torch.argmax(logits[0, 0].float()))

    @torch.no_grad()
    def _decode(self, rows, ids, pos) -> np.ndarray:
        dctx = dataclasses.replace(self.ctx, paged_rows=rows)
        logits, _ = lm.decode_step(self.params, self.cfg, dctx, ids, pos,
                                   self.kv.pool)
        return torch.argmax(logits.float(), -1).cpu().numpy()

    # ---------------------------------------------------------- public API

    def add_request(self, prompt, max_new: int,
                    stop_token: int | None = None) -> int:
        prompt = [int(t) for t in prompt]
        limit = (self.ecfg.page_len if self.ecfg.chunk_len is not None
                 else self.ecfg.prefill_len)
        if not prompt or len(prompt) > limit:
            raise ValueError(f"prompt length {len(prompt)} not in "
                             f"[1, {limit}]")
        if max_new < 1:
            raise ValueError("max_new must be >= 1 (prefill emits a token)")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      stop_token=stop_token, arrival=self._step_idx)
        self.requests[rid] = req
        self.sched.add(req)
        self.obs.request_enqueued(rid, n_prompt=len(prompt))
        return rid

    def step(self) -> list:
        """One scheduled unit of work (a prefill, a prefill chunk or a
        decode step). Returns the requests that finished during it."""
        avail = self.kv.num_free + (
            self.prefix.n_evictable if self.prefix is not None else 0)
        action = self.sched.plan(avail)
        if action == "idle":
            return []
        self._step_idx += 1
        if action == "prefill":
            done = (self._run_prefill_chunk()
                    if self.ecfg.chunk_len is not None
                    else self._run_prefill())
        else:
            done = self._run_decode()
        self.obs.lanes_state(len(self.sched.waiting), self.sched.num_active,
                             self.kv.num_free)
        return done

    def run(self, max_steps: int = 100_000) -> dict:
        """Drive until every queued request completes; {rid: tokens}."""
        for _ in range(max_steps):
            if not self.sched.has_work:
                break
            self.step()
        if self.sched.has_work:
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return {rid: list(r.out) for rid, r in self.requests.items()}

    def trace_report(self) -> pipe_mod.TraceReport:
        """The recorded step events mapped onto the FWS pipeline model."""
        return pipe_mod.simulate_trace(self.obs.steps, self.cfg.d_model,
                                       self.ecfg.lanes)

    @property
    def slot_utilization(self) -> float:
        """Mean fraction of decode lanes doing live work (vs parked)."""
        decodes = [len(e.rids) for e in self.obs.steps if e.kind == "decode"]
        if not decodes:
            return 1.0
        return sum(decodes) / (self.ecfg.lanes * len(decodes))

    def prefix_stats(self) -> dict:
        return self.prefix.stats() if self.prefix is not None else {}

    # ----------------------------------------------------------- internals

    def _alloc_slot(self) -> int:
        """A page slot for an admission, evicting LRU prefix-cache pages
        while the free list is dry. Raises :class:`PoolExhausted` when
        every slot is referenced by a live request."""
        while True:
            slot = self.kv.allocator.try_alloc()
            if slot is not None:
                return slot
            if self.prefix is None or not self.prefix.evict_lru():
                raise PoolExhausted(
                    "no free KV page slots and no evictable cached pages "
                    f"(num_slots={self.ecfg.num_slots})")

    def _admit_chunked(self) -> Request:
        """Admission on the chunked path: prefix-cache lookup, slot
        allocation (with LRU eviction) and the page clone or reset."""
        nxt = self.sched.waiting[0]
        hit = (self.prefix.match(nxt.prompt, self.kv)
               if self.prefix is not None else None)
        if hit is not None:
            # pin the donor: the allocation below may evict, and must not
            # pick the page we clone from
            self.kv.allocator.retain(hit.slot)
        try:
            slot = self._alloc_slot()
        except PoolExhausted:
            if hit is None:
                raise
            # the donor was the only evictable page: give it up for the
            # admission itself, and the hit becomes a miss
            self.kv.allocator.release(hit.slot)
            hit = None
            slot = self._alloc_slot()
        req = self.sched.begin_prefill(slot, self._step_idx)
        self.obs.request_admitted(req.rid)
        # always clone: n = 0 zeroes the (maybe reused, stale) page so the
        # mirrors' invariant holds; n > 0 is the prefix copy-on-write
        clone_prefix(self.kv.pool, self.kv.specs,
                     hit.slot if hit is not None else slot, slot,
                     hit.n_tokens if hit is not None else 0)
        if hit is not None:
            req.prefilled = req.prefix_hit = hit.n_tokens
            self.kv.allocator.release(hit.slot)
        return req

    def _run_prefill(self) -> list:
        t0 = self.obs.clock()
        slot = self._alloc_slot()
        req = self.sched.admit(slot, self._step_idx)
        self.obs.request_admitted(req.rid)
        n, p = len(req.prompt), self.ecfg.prefill_len
        ids = np.zeros((1, p), np.int64)
        ids[0, :n] = req.prompt
        positions = np.full((1, p), attn_mod.KV_PAD, np.int64)
        positions[0, :n] = np.arange(n)
        tok = self._prefill(torch.from_numpy(ids).to(self.device),
                            torch.from_numpy(positions).to(self.device),
                            slot, n - 1)
        req.out.append(tok)  # host read: the step is complete here
        t1 = self.obs.clock()
        # bill the executed width (the fixed-shape step runs all of it)
        self.obs.step_recorded("prefill", (req.rid,), p, t0, t1)
        self.obs.token_emitted(req.rid, t1)
        return self._retire([req])

    def _run_prefill_chunk(self) -> list:
        t0 = self.obs.clock()
        L = self.ecfg.chunk_len
        req = self.sched.prefilling
        if req is None:
            req = self._admit_chunked()
        offs = req.prefilled
        take = min(L, len(req.prompt) - offs)
        ids = np.zeros((1, L), np.int64)
        ids[0, :take] = req.prompt[offs:offs + take]
        positions = np.full((1, L), attn_mod.KV_PAD, np.int64)
        positions[0, :take] = np.arange(offs, offs + take)
        tok = self._chunk(req.slot, torch.from_numpy(ids).to(self.device),
                          torch.from_numpy(positions).to(self.device), offs,
                          take - 1)
        t1 = self.obs.clock()  # host read above: the step is complete
        self.obs.step_recorded("prefill", (req.rid,), L, t0, t1)
        req.prefilled = offs + take
        if req.prefilled < len(req.prompt):
            return []
        # the prompt is resident: the last chunk's logits give the first
        # token, and the finished prefix becomes donatable
        self.sched.finish_prefill(req)
        req.out.append(tok)
        self.obs.token_emitted(req.rid, t1)
        if self.prefix is not None:
            self.prefix.insert(req.prompt, req.slot, self.kv)
        return self._retire([req])

    def _run_decode(self) -> list:
        t0 = self.obs.clock()
        lanes = self.ecfg.lanes
        rows = np.asarray([self.kv.scratch_row(i) for i in range(lanes)],
                          np.int64)
        ids = np.zeros((lanes, 1), np.int64)
        pos = np.zeros((lanes,), np.int64)
        active = sorted(self.sched.running.items())
        for lane, req in active:
            rows[lane] = req.slot
            ids[lane, 0] = req.out[-1]
            pos[lane] = req.pos
        next_ids = self._decode(torch.from_numpy(rows).to(self.device),
                                torch.from_numpy(ids).to(self.device),
                                torch.from_numpy(pos).to(self.device))
        t1 = self.obs.clock()
        for lane, req in active:
            req.out.append(int(next_ids[lane]))
            req.pos += 1
            self.obs.token_emitted(req.rid, t1)
        self.obs.step_recorded("decode", tuple(r.rid for _, r in active),
                               len(active), t0, t1, lanes=lanes)
        return self._retire([r for _, r in active])

    def _retire(self, reqs) -> list:
        done = []
        for req in reqs:
            reason = Scheduler.stop_reason(req, self.ecfg.page_len)
            if reason is not None:
                self.sched.finish(req, self._step_idx)
                # drop the engine's reference; the prefix cache may keep
                # its own and the page warm for later shared prefixes
                self.kv.allocator.free(req.slot)
                self.obs.request_finished(req.rid, reason)
                done.append(req)
        return done
