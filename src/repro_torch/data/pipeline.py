"""Deterministic synthetic training data (the reference's
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), drawn from the
reference's numpy stream, so its ids, labels, masks and embeddings are
bitwise the reference's, restarted training sees the same data
(the trainer's kill-restart relies on it), and no two steps repeat. A
host thread prefetches the next batches as numpy while the device runs;
the tensors move to the device in the caller's thread.

A data rank of the sharded train step takes its rows of the global batch
(:func:`rank_rows`) in the reference's order: the k microbatches split
the global batch first, then each microbatch's rows split over the data
ranks.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, Shape


def make_batch_np(cfg: ArchConfig, shape: Shape, seed: int, step: int
                  ) -> dict:
    """Pure: (cfg, shape, seed, step) -> the train batch as numpy arrays:
    ``ids`` / ``labels`` int32 [B, S] and ``loss_mask`` f32 (an LM: a
    random stream with repeated 7-grams, so it can be learnt), ``vis_emb``
    f32 [B, n_vis, frontend_dim] for the vision front end; for audio,
    ``emb`` f32 [B, S, frontend_dim] with masked-prediction labels on
    ~8% of the frames."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0xC1A0]))
    b, s = shape.batch, shape.seq
    out: dict = {}
    if cfg.frontend == "audio":
        out["emb"] = rng.standard_normal((b, s, cfg.frontend_dim)).astype(
            np.float32)
        mask = rng.random((b, s)) < 0.08
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
        out["loss_mask"] = mask.astype(np.float32)
        return out
    base = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    period = 7
    base[:, period:] = np.where(rng.random((b, s + 1 - period)) < 0.5,
                                base[:, :-period], base[:, period:])
    out["ids"] = base[:, :-1]
    out["labels"] = base[:, 1:].astype(np.int32)
    out["loss_mask"] = np.ones((b, s), np.float32)
    if cfg.frontend == "vision":
        out["vis_emb"] = rng.standard_normal(
            (b, cfg.n_vis_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def rank_rows(batch: dict, microbatches: int, ranks: int, rank: int
              ) -> dict:
    """Rank ``rank``'s rows of a global batch (numpy or tensors) of B
    rows for a step of ``microbatches`` (k) over ``ranks`` (W) data
    ranks: the reference reshapes the batch into k microbatches of B/k
    rows (``repro.launch.steps.make_train_step``) and its data sharding
    splits each microbatch's rows over the ranks. So the rank holds rows
    ``j B/k + rank B/(kW)`` to ``j B/k + (rank+1) B/(kW)`` of each
    microbatch j, in order: B/W rows, whose own k-way split is its part
    of each microbatch."""
    out = {}
    for name, x in batch.items():
        b = x.shape[0]
        if b % (microbatches * ranks):
            raise ValueError(f"{name}: {b} rows do not split into "
                             f"{microbatches} microbatches over {ranks} "
                             "ranks")
        per = b // (microbatches * ranks)
        y = x.reshape((microbatches, ranks, per) + tuple(x.shape[1:]))
        out[name] = y[:, rank].reshape((microbatches * per,)
                                       + tuple(x.shape[1:]))
    return out


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (the same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_batch(cfg: ArchConfig, shape: Shape, seed: int, step: int,
               device=None) -> dict:
    """:func:`make_batch_np` as tensors on ``device`` (default ``cuda``;
    raises without a GPU unless ``device="cpu"``)."""
    return to_device(make_batch_np(cfg, shape, seed, step),
                     resolve_device(device))


class Pipeline:
    """Prefetching iterator over the batches of steps ``start_step``,
    ``start_step + 1``, ...: a daemon thread makes up to ``prefetch``
    numpy batches ahead; :meth:`get` returns ``(step, batch)`` with the
    batch on ``device``. :meth:`close` stops and joins the thread. With
    ``ranks`` > 1 (or a ``rank``), each batch is rank ``rank``'s rows of
    the global one for a step of ``microbatches`` (:func:`rank_rows`)."""

    def __init__(self, cfg, shape: Shape, seed: int = 0, start_step: int = 0,
                 prefetch: int = 2, device=None, rank: int = 0,
                 ranks: int = 1, microbatches: int = 1):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.rank, self.ranks, self.microbatches = rank, ranks, microbatches
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._next = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        step = self._next
        while not self._stop.is_set():
            batch = make_batch_np(self.cfg, self.shape, self.seed, step)
            if self.ranks > 1:
                batch = rank_rows(batch, self.microbatches, self.ranks,
                                  self.rank)
            item = (step, batch)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        return step, to_device(batch, self.device)

    def close(self):
        self._stop.set()
        self._t.join(timeout=10)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
