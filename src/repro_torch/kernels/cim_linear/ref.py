"""Plain PyTorch version of the CIM kernel: the blockwise analog datapath
simulation of ``core.cim`` (same block order, bitwise)."""

from __future__ import annotations

import torch

from repro_torch.core import cim as cimlib
from repro_torch.core import mx as mxlib


def cim_linear_ref(x: torch.Tensor, w: mxlib.MXW, calib: cimlib.LayerCalib,
                   cfg: cimlib.CIMConfig | None = None) -> torch.Tensor:
    y, _ = cimlib.cim_linear(x, w, cfg or cimlib.CIMConfig(), calib)
    return y
