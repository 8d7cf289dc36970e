"""AdamW (counterpart of ``repro.optim``)."""
