"""Compatibility shim, as in the reference: ``sqnr_db`` lives in
``repro_torch.obs.fidelity``; import from ``repro_torch.obs`` in new
code."""

from __future__ import annotations

from repro_torch.obs.fidelity import sqnr_db  # noqa: F401
