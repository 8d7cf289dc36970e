"""Continuous-batching request scheduler.

Pure host-side control: it owns the waiting queue and the lane->request
map and decides, step by step, whether the engine should run a prefill
(admit one queued request into a free lane + free slot, or continue a
chunked prefill already in flight) or a decode step over the currently
active lanes. The jitted steps themselves are fixed shape; inactive
lanes ride along parked on scratch rows.

Policies:
  ``prefill`` (prefill-prioritized, throughput-first): admit whenever a
      request is waiting and a lane and a KV slot are free — fills the
      batch as fast as possible, at the cost of stalling in-flight decodes
      for one prefill step per admission. A chunked prefill runs its
      chunks back to back.
  ``decode`` (decode-prioritized, latency-first): keep decoding while any
      lane is active; admissions (and prefill chunks) happen only when
      the engine would otherwise idle (no active lanes).
  ``chunked`` (fair interleave): while both a prefill (new admission or
      in-flight chunk sequence) and live decode lanes want the engine,
      alternate one prefill-chunk step with one decode step — long
      prompts no longer stall decode lanes for their whole prefill.

Stop conditions, checked after every generated token: ``max_new_tokens``
reached, the optional per-request ``stop_token`` sampled, or the KV page
exhausted (``pos == page_len``). Completion frees both the lane and the
KV slot (eviction), immediately re-admittable.
"""

from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    stop_token: int | None = None
    arrival: int = 0  # engine step index at which the request was added
    # runtime state (engine-owned)
    lane: int = -1
    slot: int = -1
    pos: int = 0  # next decode position == len(prompt) + len(out)
    out: list[int] = dataclasses.field(default_factory=list)
    prefill_step: int = -1  # engine step index of the (first) prefill
    finish_step: int = -1
    prefilled: int = 0  # prompt tokens already resident in the KV page
    prefix_hit: int = 0  # of which came from the prefix cache

    @property
    def done(self) -> bool:
        return self.finish_step >= 0


class Scheduler:
    def __init__(self, lanes: int, policy: str = "prefill", obs=None):
        if policy not in ("prefill", "decode", "chunked"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.lanes = lanes
        self.policy = policy
        self.obs = obs  # repro_torch.obs.Obs handle (None: no telemetry)
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}  # lane -> request
        self.prefilling: Request | None = None  # mid-chunked-prefill
        self._free_lanes = list(range(lanes - 1, -1, -1))
        self._last = "idle"  # last planned action (chunked interleave)

    def _gauges(self) -> None:
        if self.obs is None or not self.obs.enabled:
            return
        reg = self.obs.registry
        reg.gauge("serve_queue_depth", "waiting requests").set(
            len(self.waiting)
        )
        reg.gauge("serve_active_lanes", "lanes decoding live work").set(
            len(self.running)
        )

    # ------------------------------------------------------------- queries

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running
                    or self.prefilling is not None)

    @property
    def num_active(self) -> int:
        return len(self.running)

    def plan(self, free_slots: int) -> str:
        """Next engine action: 'prefill' | 'decode' | 'idle'.

        ``free_slots`` is the number of KV page slots the engine could
        produce for an admission — with a prefix cache attached that
        includes evictable cached pages, not just the allocator's free
        list.
        """
        can_admit = bool(self.waiting) and bool(self._free_lanes) \
            and free_slots > 0 and self.prefilling is None
        wants_prefill = can_admit or self.prefilling is not None
        if self.policy == "chunked":
            if wants_prefill and self.running:
                action = "decode" if self._last == "prefill" else "prefill"
            elif wants_prefill:
                action = "prefill"
            else:
                action = "decode" if self.running else "idle"
        elif wants_prefill and (self.policy == "prefill"
                                or not self.running):
            action = "prefill"
        elif self.running:
            action = "decode"
        else:
            action = "idle"
        if action != "idle":
            self._last = action
        if self.obs is not None and self.obs.enabled:
            self.obs.registry.counter(
                "serve_sched_decisions_total",
                "scheduler plan() outcomes by action",
                labels={"action": action, "policy": self.policy},
            ).inc()
        return action

    # ----------------------------------------------------------- mutation

    def add(self, req: Request) -> None:
        self.waiting.append(req)
        self._gauges()

    def admit(self, slot: int, step: int) -> Request:
        """Pop the next waiting request onto a free lane with KV slot
        ``slot``. Caller (the engine) allocated the slot. Single-shot
        prefill admission: the request is immediately decodable."""
        req = self.begin_prefill(slot, step)
        self.finish_prefill(req)
        return req

    def begin_prefill(self, slot: int, step: int) -> Request:
        """Chunked admission: the request takes a lane and a slot but is
        *not* decodable yet — it sits in ``self.prefilling`` (owning its
        lane, outside ``running``) until :meth:`finish_prefill`."""
        if self.prefilling is not None:
            raise RuntimeError("a chunked prefill is already in flight")
        req = self.waiting.popleft()
        req.lane = self._free_lanes.pop()
        req.slot = slot
        req.prefill_step = step
        self.prefilling = req
        self._gauges()
        return req

    def finish_prefill(self, req: Request) -> None:
        """The whole prompt is resident: move the request onto its lane's
        decode seat."""
        if self.prefilling is req:
            self.prefilling = None
        req.pos = len(req.prompt)
        req.prefilled = len(req.prompt)
        self.running[req.lane] = req
        self._gauges()

    def finish(self, req: Request, step: int) -> None:
        """Evict a completed request: frees the lane (the engine frees the
        KV slot, which it owns via the allocator)."""
        req.finish_step = step
        del self.running[req.lane]
        self._free_lanes.append(req.lane)
        self._gauges()

    @staticmethod
    def stop_reason(req: Request, page_len: int) -> str | None:
        """Why the request stops now, or None if it keeps decoding:
        ``max_new`` (token budget reached), ``stop_token`` (sampled the
        per-request stop id), ``page_exhausted`` (KV page full — the
        eviction case). Completion reasons are checked before exhaustion
        so a request that fills its page *on* its last budgeted token
        still counts as completed; ``page_exhausted`` is reachable
        because the engine admits ``len(prompt) + max_new > page_len``
        (it used to reject those up front, which made this arm dead
        code)."""
        if len(req.out) >= req.max_new:
            return "max_new"
        if (req.stop_token is not None and req.out
                and req.out[-1] == req.stop_token):
            return "stop_token"
        if req.pos >= page_len:
            return "page_exhausted"
        return None

    @classmethod
    def stopped(cls, req: Request, page_len: int) -> bool:
        return cls.stop_reason(req, page_len) is not None


def static_batching_plan(requests: list[Request], lanes: int,
                         prefill_len: int | None = None):
    """Reference naive static batching: requests grouped ``lanes`` at a
    time; each group prefills every member, then decodes until the
    *longest* member finishes (no eviction, no backfill). Returns the same
    (kind, rids, n_tokens) event-trace format the engine emits, for the
    pipeline model's continuous-vs-static comparison.

    ``prefill_len`` bills each prefill at the executed padded width (what
    the engine's fixed-shape step actually pushes through the FWS
    pipeline); ``None`` keeps the historical per-prompt billing.
    """
    events = []
    for g in range(0, len(requests), lanes):
        group = requests[g:g + lanes]
        for r in group:
            events.append(
                ("prefill", (r.rid,),
                 len(r.prompt) if prefill_len is None else prefill_len)
            )
        steps = max(r.max_new - 1 for r in group) if group else 0
        for t in range(steps):
            live = tuple(r.rid for r in group if r.max_new - 1 > t)
            # every lane of the group occupies the pipeline whether or not
            # its request is still live — that's the waste being measured
            events.append(("decode", live, len(group)))
    return events
