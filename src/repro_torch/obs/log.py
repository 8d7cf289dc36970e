"""Structured logging for the serving launchers.

One compact line per record: ``HH:MM:SS.mmm L name| msg key=value ...``.
``get_logger`` configures a stream handler once per logger and is
idempotent; ``kv(...)`` renders a field dict in stable order so step
summaries stay grep-able (``live=3 tok_s=41.2 free_slots=2``).
"""

from __future__ import annotations

import logging

_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s| %(message)s"
_DATEFMT = "%H:%M:%S"

LEVELS = ("debug", "info", "warning", "error")


def get_logger(name: str = "repro_torch.serve",
               level: str = "info") -> logging.Logger:
    if level not in LEVELS:
        raise ValueError(f"unknown log level {level!r} (one of {LEVELS})")
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper()))
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(h)
        logger.propagate = False
    return logger


def kv(**fields) -> str:
    """Render fields as ``k=v`` pairs in insertion order; floats get a
    compact fixed precision."""
    parts = []
    for k, v in fields.items():
        if isinstance(v, float):
            v = f"{v:.4g}"
        parts.append(f"{k}={v}")
    return " ".join(parts)
