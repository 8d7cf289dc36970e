"""MXFormer analytical performance/area/power model (a copy of
``repro.hwmodel.perf``; the port imports nothing of ``repro``).

Derivations (validated against the paper in tests/test_hwmodel.py):

Analog macro (Table 3):
    TOPS_1pass = 2 * H^2 * f_analog / (BITPLANES * MUX)
    (768: 19.93 vs 20.02 paper; 1024: 35.44 vs 35.72 — <1.5%)

Pipeline (§5.3): every CTT array consumes one token per
BITPLANES*MUX*PASSES = 20 analog cycles, so
    T_analog(N) = N * 20 / 169 MHz           (per stage, 2-pass)
The digital stage runs the two 32x64 systolic arrays over
tile-quantized attention matmuls:
    T_digital(N, d) = C_D0 * (d/768) * ceil32(N) * ceil64(N)
with C_D0 calibrated once from BERT-Base (N=512, digital-bound,
9,055 seq/s). Steady-state throughput = 1/max(T_a, T_d) — this
reproduces all eight Table-7 FPS figures within ~4% (most <1%).

I/O penalty (Table 1): weights fp16, per-item activation traffic
4 B/elem (in+out bf16), resident activations 0.5 B/elem (FP4):
    B* = floor(30 MB / (N*d*0.5));  penalty(B) = 1 + W/(B*N*d*4)
"""

from __future__ import annotations

import math

from repro_torch.hwmodel import specs as S


def ceil_to(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m`` (systolic tile quantization:
    the digital stage processes attention matmuls in 32x64 tiles, so
    ``t_digital`` bills ceil32(N) * ceil64(N))."""
    return -(-n // m) * m


# ------------------------------------------------------------- macro model

def macro_tops(hidden: int, passes: int = 1) -> float:
    return 2 * hidden * hidden * S.ANALOG_CLK / (
        S.BITPLANES * S.MUX * passes
    ) / 1e12


def macro_area_mm2(hidden: int) -> float:
    return S.MACRO[hidden]["area_mm2"]


def macro_power_w(hidden: int) -> float:
    return S.MACRO[hidden]["tops_1pass"] / S.MACRO[hidden]["tops_w"]


def storage_density_kb_mm2(hidden: int) -> float:
    bits = hidden * hidden * S.CTT_BITS_PER_CELL
    return bits / 1e3 / macro_area_mm2(hidden)


# ------------------------------------------------------------ system model

def n_arrays(sys: S.SystemSpec) -> int:
    return sys.n_blocks * sys.arrays_per_block


def analog_tops(sys: S.SystemSpec, passes: int = S.PASSES) -> float:
    return n_arrays(sys) * macro_tops(sys.hidden, passes)


def digital_peak_tops(sys: S.SystemSpec) -> float:
    macs = 2 * sys.sa_rows * sys.sa_cols  # two arrays per block
    return sys.n_blocks * macs * 2 * S.DIGITAL_CLK / 1e12


def t_analog(n_tokens: int, passes: int = S.PASSES) -> float:
    cyc = S.BITPLANES * S.MUX * passes
    return n_tokens * cyc / S.ANALOG_CLK


def t_digital(n_tokens: int, d_model: int) -> float:
    return (
        S.C_D0
        * (d_model / 768.0)
        * ceil_to(n_tokens, 32)
        * ceil_to(n_tokens, 64)
    )


def stage_time(n_tokens: int, d_model: int) -> float:
    return max(t_analog(n_tokens), t_digital(n_tokens, d_model))


def t_interchip(n_tokens: int, d_model: int) -> float:
    """One inter-chip hop in a multi-chip FWS pipeline (vit-l32 /
    bert-large: 24 blocks split 12+12): the [N, d] bf16 activation tile
    crosses the chip-to-chip link. Far below ``stage_time`` for every
    Table-7 shape, so the hop adds latency but never bounds throughput."""
    return n_tokens * d_model * 2 / (S.INTERCHIP_GBPS * 1e9)


def steady_state_fps(n_tokens: int, d_model: int = 768) -> float:
    """Steady-state items/s of the fully weight-stationary pipeline once
    every stage is occupied: one item leaves the last block every
    ``stage_time`` (§5.3), so FPS = 1 / max(T_analog, T_digital).

    This is the quantity reported per model in Table 7 — e.g. rows
    ``vit-b16`` (N=197, d=768 -> 41,269 fps), ``bert-base`` (N=512,
    d=768 -> 9,055 fps), ``vit-l14``/``bert-large`` (d=1024, Large
    system) — and is what ``serving/pipeline.py``'s discrete-event model
    must converge to once its twelve stages fill."""
    return 1.0 / stage_time(n_tokens, d_model)


def n_balance(sys: S.SystemSpec) -> float:
    """Sequence length where analog and digital stage times cross."""
    # t_a = 20N/f ; t_d ~ C_D0*(d/768)*N^2  (ignoring tile quantization)
    return (20 / S.ANALOG_CLK) / (S.C_D0 * sys.hidden / 768.0)


def flops_per_item(w: S.Workload) -> float:
    """Encoder inference FLOPs: linear 24*d^2/token + attention 4*N*d."""
    return w.seq * w.layers * (24 * w.d * w.d + 4 * w.seq * w.d)


def fps(w: S.Workload) -> float:
    return 1.0 / stage_time(w.seq, w.d)


def tops(w: S.Workload) -> float:
    return flops_per_item(w) * fps(w) / 1e12


def system_peak_tops(sys: S.SystemSpec) -> float:
    nb = round(n_balance(sys))
    t = stage_time(nb, sys.hidden)
    util_d = t_digital(nb, sys.hidden) / t
    return analog_tops(sys) + digital_peak_tops(sys) * min(util_d, 1.0)


def system_area_mm2(sys: S.SystemSpec) -> float:
    c = S.COMPONENTS[sys.name]
    ctt = n_arrays(sys) * macro_area_mm2(sys.hidden)
    return ctt + sum(v for k, v in c.items() if k.endswith("_area"))


def system_power_w(sys: S.SystemSpec, util_a: float = 1.0,
                   util_d: float = 1.0) -> float:
    c = S.COMPONENTS[sys.name]
    ctt = n_arrays(sys) * macro_power_w(sys.hidden)
    digital = sum(v for k, v in c.items() if k.endswith("_power"))
    return ctt * util_a + digital * util_d


def model_power_w(w: S.Workload) -> float:
    sys = S.BASE if w.system == "base" else S.LARGE
    t = stage_time(w.seq, w.d)
    util_a = t_analog(w.seq) / t
    util_d = min(t_digital(w.seq, w.d) / t, 1.0)
    return w.chips * system_power_w(sys, util_a, util_d)


# --------------------------------------------------------------- Table 1

def io_penalty(w: S.Workload):
    """(penalty at max batch, max batch, penalty at batch 1)."""
    weights = w.params_m * 1e6 * 2  # fp16 bytes
    act_traffic = w.seq * w.d * 4.0  # in+out bf16 per item
    act_resident = w.seq * w.d * 0.5  # FP4 resident
    bmax = int(S.A100_L2_BYTES // act_resident)

    def penalty(b):
        return 1.0 + weights / (b * act_traffic)

    return penalty(bmax), bmax, penalty(1)


# --------------------------------------------------------------- Fig 12

def fig12_sweep(sys: S.SystemSpec = S.BASE, ns=None):
    ns = ns or [16, 32, 64, 96, 128, 192, 256, 320, 384, 448, 512]
    rows = []
    for n in ns:
        w = S.Workload("sweep", sys.hidden, sys.n_blocks, n, 0)
        rows.append({
            "N": n,
            "t_analog_us": t_analog(n) * 1e6,
            "t_digital_us": t_digital(n, sys.hidden) * 1e6,
            "t_stage_us": stage_time(n, sys.hidden) * 1e6,
            "tops": tops(w),
            "fps": fps(w),
        })
    return rows


# ------------------------------------------------------- Tables 4/7 builds

def table4():
    out = {}
    for sys in (S.BASE, S.LARGE):
        peak = system_peak_tops(sys)
        area = system_area_mm2(sys)
        nb = round(n_balance(sys))
        t = stage_time(nb, sys.hidden)
        power = system_power_w(
            sys, t_analog(nb) / t, min(t_digital(nb, sys.hidden) / t, 1.0)
        )
        out[sys.name] = {
            "tops": peak, "area_mm2": area, "power_w": power,
            "tops_mm2": peak / area, "tops_w": peak / power,
            "n_balance": nb,
        }
    return out


def table7():
    out = {}
    for name, w in S.WORKLOADS.items():
        if name not in S.PAPER_TABLE7 and name not in ("bert-large-128",
                                                       "deit-b16"):
            continue
        sys = S.BASE if w.system == "base" else S.LARGE
        f = fps(w)
        out[name] = {
            "fps": f,
            "tops": tops(w),
            "power_w": model_power_w(w),
            "tops_mm2": tops(w) / (w.chips * system_area_mm2(sys)),
            "tops_w": tops(w) / model_power_w(w),
        }
    return out
