"""Deterministic synthetic training data (the reference's
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), drawn from the
reference's numpy stream, so its ids, labels, masks and embeddings are
bitwise the reference's, restarted training sees the same data
(the trainer's kill-restart relies on it), and no two steps repeat. A
host thread prefetches the next batches as numpy while the device runs;
the tensors move to the device in the caller's thread.
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
    batch on ``device``. :meth:`close` stops and joins the thread."""

    def __init__(self, cfg, shape: Shape, seed: int = 0, start_step: int = 0,
                 prefetch: int = 2, device=None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._next = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        step = self._next
        while not self._stop.is_set():
            item = (step, make_batch_np(self.cfg, self.shape, self.seed,
                                        step))
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
