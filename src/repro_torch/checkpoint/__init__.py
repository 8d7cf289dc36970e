"""Atomic, async checkpoints (counterpart of ``repro.checkpoint``)."""
