"""The synthetic training data stream (counterpart of ``repro.data``)."""
