"""Hardware constants and workload specs for the MXFormer analytical
performance model (paper Tables 1-9, Fig 12). Derivations in perf.py.
A copy of ``repro.hwmodel.specs``; the port imports nothing of ``repro``."""

from __future__ import annotations

import dataclasses

ANALOG_CLK = 169e6  # Hz (paper §5)
DIGITAL_CLK = 1e9
BITPLANES = 5  # INT5 bit-serial input streaming
MUX = 2  # bit-line multiplexing degree (derived from Table 3)
PASSES = 2  # Row-Hist 2-Pass (halves analog throughput)
CM_BITS = 3
ADC_BITS = 10
CTT_BITS_PER_CELL = 5

# Table 3 (macro, 22nm FDSOI; area mm^2; derived checks in tests)
MACRO = {
    768: {"area_mm2": 1.78, "tops_1pass": 20.02, "tops_w": 58.83,
          "tops_mm2": 11.26},
    1024: {"area_mm2": 2.97, "tops_1pass": 35.72, "tops_w": 75.72,
           "tops_mm2": 12.02},
}

# Table 5 component area/power (constants as published; CTT derived)
COMPONENTS = {
    "base": {
        "systolic_area": 58.25, "systolic_power": 87.51,
        "vector_area": 14.54, "vector_power": 16.82,
        "quant_area": 7.89, "quant_power": 6.99,
        "transp_area": 1.15, "transp_power": 1.10,
        "buffer_area": 2.05, "buffer_power": 1.70,
        "sram_area": 34.98, "sram_power": 0.12,
    },
    "large": {
        "systolic_area": 58.25, "systolic_power": 85.23,
        "vector_area": 17.35, "vector_power": 19.14,
        "quant_area": 7.89, "quant_power": 6.91,
        "transp_area": 1.15, "transp_power": 1.07,
        "buffer_area": 2.73, "buffer_power": 2.26,
        "sram_area": 46.43, "sram_power": 0.20,
    },
}


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    name: str
    hidden: int  # CTT array edge (768 Base / 1024 Large)
    n_blocks: int = 12  # Transformer blocks per die
    arrays_per_block: int = 12  # 4 proj + 2 FFN "large arrays" of 4 each
    # digital: two 32x64 output-stationary systolic arrays per block
    sa_rows: int = 32
    sa_cols: int = 64
    # calibrated digital per-layer time constant (see perf.py):
    #   T_d = C_D0 * (d_model/768) * ceil32(N) * ceil64(N) [seconds]
    # single calibration point: BERT-Base @ N=512 = 9,055 seq/s (Table 7)


BASE = SystemSpec("base", 768)
LARGE = SystemSpec("large", 1024)
C_D0 = 1.0 / (9055 * 512 * 512) / (768 / 768)  # = 0.4213 ns

# Paper workload models (encoder, d/L/heads/params/seq at max input size)
@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    d: int
    layers: int
    seq: int
    params_m: float  # backbone params (millions)
    chips: int = 1
    system: str = "base"


WORKLOADS = {
    "vit-b32": Workload("vit-b32", 768, 12, 50, 88),  # CLIP vision tower
    "vit-b16": Workload("vit-b16", 768, 12, 197, 86),
    "vit-b14": Workload("vit-b14", 768, 12, 257, 86),  # DINOv2
    "vit-s16": Workload("vit-s16", 384, 12, 197, 22),
    "bert-base": Workload("bert-base", 768, 12, 512, 110),
    "vit-l32": Workload("vit-l32", 1024, 24, 145, 307, chips=2, system="large"),
    "vit-l14": Workload("vit-l14", 1024, 24, 257, 304, chips=2, system="large"),
    "bert-large": Workload("bert-large", 1024, 24, 512, 340, chips=2,
                           system="large"),
    "bert-large-128": Workload("bert-large-128", 1024, 24, 128, 340, chips=2,
                               system="large"),
    # DeiT-B/16 shares ViT-B/16 geometry (d=768, 12 layers, N=197, 86M
    # backbone params): the paper reports it only in Table 9 (SOTA
    # comparison, 41,269 img/s on Base) — PAPER_TABLE9 below, validated in
    # tests/test_hwmodel.py next to the Table 7 sweep. It has no separate
    # Table 1 row because the identical (N, d, params) makes its I/O
    # penalty figures coincide with vit-b16's (also pinned in tests).
    "deit-b16": Workload("deit-b16", 768, 12, 197, 86),
}

# Paper-reported results for validation (Table 4 & Table 7)
PAPER_TABLE4 = {
    "base": {"area_mm2": 376.3, "power_w": 163.16, "tops": 1515.14,
             "tops_mm2": 4.04, "tops_w": 9.29},
    "large": {"area_mm2": 561.5, "power_w": 182.61, "tops": 2631.56,
              "tops_mm2": 4.69, "tops_w": 14.41},
}
PAPER_TABLE7 = {  # model -> (power_w, fps, tops)
    "vit-b32": (96.5, 169000, 1451),
    "vit-b16": (170.6, 41269, 1440),
    "vit-b14": (161.1, 25716, 1204),
    "bert-base": (147.1, 9055, 875),
    "vit-s16": (122.2, 42893, 389),
    "vit-l32": (385.5, 58275, 5224),
    "vit-l14": (327.4, 19839, 3208),
    "bert-large": (299.2, 6983, 2338),
}
PAPER_TABLE9 = {  # model -> fps (SOTA comparison; fps-only rows)
    "deit-b16": 41269,
}
PAPER_TABLE1 = {  # model -> (penalty_max_batch, max_batch, penalty_b1)
    "bert-base": (1.93, 150, 140),
    "bert-large": (3.86, 112, 320),
    "vit-b16": (1.73, 391, 285),
    "vit-b32": (1.73, 1542, 1120),
    "vit-l32": (3.59, 398, 1029),
}

# Table 2 NVM comparison (for the density benchmark)
NVM = {
    "nor_flash": {"cell_f2": 10, "read_ns": 50, "max_bits": 3},
    "reram": {"cell_f2": 27, "read_ns": 15, "max_bits": 4},
    "feram": {"cell_f2": 21, "read_ns": 35, "max_bits": 3},
    "pcm": {"cell_f2": 27, "read_ns": 12.5, "max_bits": 4},
    "ctt": {"cell_f2": 5, "read_ns": 7.5, "max_bits": 6},
}

A100_L2_BYTES = 30e6  # Table 1 persistent L2

# Dual-chip deployments (vit-l32 / bert-large: 24 blocks split 12+12)
# forward activations across a chip-to-chip link between stage 12 and 13.
# The paper treats the hop as pipeline-hidden; this models it as one extra
# pipeline stage moving N*d bf16 activations at a conservative link rate,
# which stays far below stage_time for every Table-7 shape.
INTERCHIP_GBPS = 100.0
