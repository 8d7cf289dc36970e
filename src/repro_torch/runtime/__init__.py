"""The fault-tolerant trainer (counterpart of ``repro.runtime``)."""
