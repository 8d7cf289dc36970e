"""The MXFormer chip's analytical performance, area and power model
(paper Tables 1-9, Fig. 12): a copy of ``repro.hwmodel``. Its FPS and
latencies are the modelled CTT-CIM chip's, not a speed of the GPU the
port runs on."""

from repro_torch.hwmodel import perf, specs  # noqa: F401
