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

On CUDA every step is one CUDA graph (``serving/graphs.py``, the
counterpart of the reference's jitted steps): the prefill, the chunk, the
clone at chunked admission and the decode step. Each step's inputs are
one static int64 device buffer (ids, positions, pool rows, the last
prompt index, ...), filled before each call by one copy from a pinned
host array; the prefill, chunk and decode steps end in their greedy
argmax, written to a static buffer whose host read ends the step. One
graph serves every call of its step (parked decode lanes keep their
scratch rows), and holds the pool's tensors, which are only ever written
in place. ``EngineConfig(cuda_graphs=False)`` runs the steps eagerly
instead; ``impl="ref"`` runs only so.

Warm-up. A graph's first call runs its step eagerly twice before the
capture and then replays it, all on the input of that call. Each step is
idempotent on its input, so this writes what one call writes: the
prefill and the clone overwrite the whole destination page row; the chunk
writes its rows before its attention reads the page, and recomputes the
mirrors from the whole page; decode writes its one row before it reads.
``tests/test_torch_graphs.py`` runs each step twice and holds the pool to
one run.

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
import functools

import numpy as np
import torch

from repro_torch.layers import attention as attn_mod
from repro_torch.models import lm
from repro_torch.obs import Obs
from repro_torch.serving import pipeline as pipe_mod
from repro_torch.serving.graphs import StepGraph
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
    # on CUDA, replay the prefill, chunk, clone and decode steps as
    # captured CUDA graphs (False: run them eagerly, e.g. to compare the
    # two); the CPU runs them eagerly
    cuda_graphs: bool = True


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
        pool, specs = self.kv.pool, self.kv.specs
        # each step: (its function of the static input, that input's
        # shape); the inputs are int64 and written from one pinned host
        # array a call on CUDA (layouts at the step functions)
        steps = {
            "prefill": (functools.partial(_prefill_step, params, cfg, ctx,
                                          pool, specs),
                        (2 * ecfg.prefill_len + 2,)),
            "decode": (functools.partial(_decode_step, params, cfg, ctx,
                                         pool), (3, ecfg.lanes)),
        }
        if ecfg.chunk_len is not None:
            steps["chunk"] = (functools.partial(_chunk_step, params, cfg,
                                                ctx, pool, specs),
                              (2 * ecfg.chunk_len + 3,))
            steps["clone"] = (functools.partial(_clone_step, pool, specs),
                              (3,))
        if (self.device.type == "cuda" and ecfg.cuda_graphs
                and ctx.impl == "ref"):
            raise ValueError("impl='ref' runs eagerly: pass "
                             "EngineConfig(cuda_graphs=False)")
        self._fn: dict = {}  # step name -> the eager step, or its graph
        self._in: dict = {}  # step name -> its static device input
        self._host: dict = {}  # step name -> the host array written to it
        self.graphs: dict[str, StepGraph] = {}
        for name, (fn, shape) in steps.items():
            buf = torch.zeros(shape, dtype=torch.int64, device=self.device)
            self._in[name] = self._host[name] = buf
            self._fn[name] = functools.partial(fn, buf)
            if self.device.type == "cuda":
                self._host[name] = torch.zeros(shape,
                                               dtype=torch.int64).pin_memory()
                if ecfg.cuda_graphs:
                    self.graphs[name] = self._fn[name] = StepGraph(
                        fn, buf, obs=ctx.obs)

    # --------------------------------------------------------------- steps

    def _call(self, name: str) -> torch.Tensor | None:
        """Step ``name`` on what its host array holds: on CUDA one copy
        into its static input, then its graph's replay or the eager step.
        Returns the step's output, a device tensor (None for the clone)."""
        host, buf = self._host[name], self._in[name]
        if host is not buf:
            # pinned: asynchronous; the host read that ended the previous
            # step has waited for the previous copy from this array
            buf.copy_(host, non_blocking=True)
        return self._fn[name]()

    # ---------------------------------------------------------- public API

    def add_request(self, prompt, max_new: int,
                    stop_token: int | None = None) -> int:
        prompt = [int(t) for t in prompt]
        limit = (self.ecfg.page_len if self.ecfg.chunk_len is not None
                 else self.ecfg.prefill_len)
        if not prompt or len(prompt) > limit:
            raise ValueError(f"prompt length {len(prompt)} not in "
                             f"[1, {limit}]")
        # an id past the embedding would fire a device-side assert on CUDA
        # (the reference's jnp.take fills NaN rows instead)
        bad = [t for t in prompt if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"prompt ids {bad[:4]} not in [0, "
                             f"{self.cfg.vocab_size})")
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

    @property
    def trace(self) -> list:
        """The classic ``(kind, rids, n_tokens)`` tuple list the pipeline
        model consumes, rebuilt from the typed step events
        (``self.obs.steps``)."""
        return self.obs.legacy_trace()

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
        # mirrors' invariant holds; n > 0 is the prefix copy-on-write. The
        # first chunk step's host read ends it.
        self._host["clone"].numpy()[:] = (
            (hit.slot, slot, hit.n_tokens) if hit is not None
            else (slot, slot, 0))
        self._call("clone")
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
        step = self._host["prefill"].numpy()
        _window(step, p, req.prompt, 0)
        step[2 * p:] = (slot, n - 1)
        tok = int(self._call("prefill")[0])
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
        step = self._host["chunk"].numpy()
        _window(step, L, req.prompt[offs:offs + take], offs)
        step[2 * L:] = (req.slot, take - 1, offs)
        tok = int(self._call("chunk")[0])
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
        step = self._host["decode"].numpy()  # rows, ids, pos of each lane
        step[0] = [self.kv.scratch_row(i) for i in range(lanes)]
        step[1:] = 0
        active = sorted(self.sched.running.items())
        for lane, req in active:
            step[:, lane] = (req.slot, req.out[-1], req.pos)
        next_ids = self._call("decode").cpu().numpy()  # ends the step
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


def _window(step: np.ndarray, width: int, tokens, offset: int) -> None:
    """Write a prompt window into a step's host array: ``tokens`` as ids
    in ``step[:width]`` (zero-padded) and their absolute positions from
    ``offset`` in ``step[width:2 * width]`` (``KV_PAD`` on pad columns)."""
    n = len(tokens)
    step[:width] = 0
    step[:n] = tokens
    step[width:2 * width] = attn_mod.KV_PAD
    step[width:width + n] = np.arange(offset, offset + n)


def _greedy(ctx, cfg, params, hidden, last) -> torch.Tensor:
    """The head over row ``last`` (int64 [1]) of ``hidden`` [1, S, d]
    only, the padded tail discarded, and its argmax: int64 [1]."""
    logits = lm._head(ctx, cfg, params, hidden.index_select(1, last))
    return torch.argmax(logits[0].float(), -1)


@torch.no_grad()
def _prefill_step(params, cfg, ctx, pool, specs, step_in) -> torch.Tensor:
    """The ``[1, P]`` single-shot prefill on ``step_in`` (int64 [2P + 2]:
    ids, positions (``arange(n)`` and a KV_PAD tail), the pool row, the
    index of the last prompt token): the prompt's page is built in fresh
    caches and written into its pool row in place; returns the greedy
    next id (int64 [1]). A function of its arguments only, so a captured
    graph of it holds no engine."""
    p = (step_in.shape[0] - 2) // 2
    ids, positions = step_in[:p][None], step_in[p:2 * p][None]
    row, last = step_in[2 * p:2 * p + 1], step_in[2 * p + 1:]
    kv = pool[0][0]["kv"]
    caches = lm.init_cache(cfg, 1, kv.shape[1],
                           mx_digital="kv_codes" in pool[0][0], fused=True,
                           device=kv.device)
    # positions are arange(n) and a KV_PAD tail: the flash kernel's layout
    hidden, caches = lm.forward(
        params, cfg, dataclasses.replace(ctx, arange_positions=True),
        {"ids": ids, "positions": positions}, caches=caches,
        return_hidden=True)
    scatter_rows(pool, specs, row, caches)
    return _greedy(ctx, cfg, params, hidden, last)


@torch.no_grad()
def _chunk_step(params, cfg, ctx, pool, specs, step_in) -> torch.Tensor:
    """One ``[1, L]`` window of a longer prompt on ``step_in`` (int64
    [2L + 3]: ids, absolute positions (KV_PAD on pad columns), the pool
    row, the index of the window's last prompt token, the window's
    offset), written into the request's page in place at its absolute
    positions; returns the greedy next id (int64 [1]). ``pos`` only
    selects attention's chunked-prefill branch, which reads the
    positions, so the offset goes in as a device scalar nothing reads.
    The page was cloned or zeroed at admission, so rows past the written
    prefix are zeros."""
    n = (step_in.shape[0] - 3) // 2
    ids, positions = step_in[:n][None], step_in[n:2 * n][None]
    row, last, offset = (step_in[2 * n:2 * n + 1],
                         step_in[2 * n + 1:2 * n + 2], step_in[2 * n + 2])
    caches = gather_rows(pool, specs, row)
    hidden, caches = lm.forward(
        params, cfg, ctx, {"ids": ids, "positions": positions},
        caches=caches, pos=offset, return_hidden=True)
    scatter_rows(pool, specs, row, caches)
    return _greedy(ctx, cfg, params, hidden, last)


@torch.no_grad()
def _clone_step(pool, specs, step_in) -> None:
    """The chunked admission's page clone or reset on ``step_in`` (int64
    [3]: donor row, destination row, prefix rows kept), in place
    (:func:`~repro_torch.serving.kvcache.clone_prefix`)."""
    clone_prefix(pool, specs, step_in[0], step_in[1], step_in[2])


@torch.no_grad()
def _decode_step(params, cfg, ctx, pool, step_in) -> torch.Tensor:
    """The ``[lanes, 1]`` decode step on ``step_in`` ([3, lanes] int64:
    pool rows, ids, positions): writes each lane's K/V row into ``pool``
    in place and returns its greedy next id (int64 [lanes]). A function
    of its arguments only, so a captured graph of it holds no engine."""
    rows, ids, pos = step_in[0], step_in[1][:, None], step_in[2]
    dctx = dataclasses.replace(ctx, paged_rows=rows)
    logits, _ = lm.decode_step(params, cfg, dctx, ids, pos, pool)
    return torch.argmax(logits.float(), -1)
