"""The port's dry-run on the CPU: the meta-device cost counter, the kernel
wrappers' ``meta`` branches and their shared ``cost()`` models, the step
builders on ``meta``, ``roofline_terms``, ``analyze_cell`` and
``launch.dryrun.run_cell``. No JAX: the dry-run's parity with the
reference's rules, specs and argument bytes is
``tests/test_torch_sharding.py``'s.

- The counter's FLOPs of a small float prefill step equal the hand sum
  of 2 M K N over its linears plus the dense attention's QK^T and PV and
  the head on the last position.
- Each of the five wrappers on ``meta`` returns its plain version's shape
  and dtype on the same inputs, records one call on the route the card
  would take with its ``cost()`` model, and leaves the launch counters
  alone; the peak counts its split-K partials.
- An ``mxfp4_wonly`` prefill and decode step (starcoder2-7b at full width,
  2 layers) make the ``mxfp4_matmul`` calls by route of the launch
  formula: prefill 6L ``wgmma`` (the step's head is dequantized, as the
  reference's ``_head_logits``), decode 6L + 1 ``mma``.
- ``roofline_terms`` on a fixed cost.
- ``run_cell`` for one tiny arch a family and each shape kind on the
  one-device mesh; one full-size cell (h2o-danube-1.8b ``train_4k`` on the
  single pod) with ``useful_flops_ratio`` <= 1; the sweep's CLI on one
  cell.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro_torch import configs as C  # noqa: E402
from repro_torch.core import cim as cimlib  # noqa: E402
from repro_torch.core import mx as mxlib  # noqa: E402
from repro_torch.distributed import roofline as rl  # noqa: E402
from repro_torch.kernels.cim_linear import ops as cim_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.paged_attention import layout  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.layers import backends  # noqa: E402
from repro_torch.obs.cost import CostCounter  # noqa: E402

META = torch.device("meta")
ONE = make_local_mesh(1, 1, device="meta")


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_meta(v) for v in tree))
    return tree.to(META) if torch.is_tensor(tree) else tree


def test_counter_flops_of_a_float_prefill_match_hand_sum():
    cfg = dataclasses.replace(C.tiny(C.ARCHS["starcoder2-7b"]), n_layers=3)
    b, s = 2, 24
    bundle = steps.make_prefill_step(cfg, ONE, C.Shape(s, b, "prefill"),
                                     quant="none", device="meta")
    with CostCounter() as c:
        ids, caches = bundle.fn(*bundle.args)
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    m = b * s
    linears = 2 * m * (d * h * hd + 2 * d * kv * hd + h * hd * d
                       + 2 * d * ff)  # wq, wk, wv, wo, w1, w2 (gelu)
    attn = 2 * (2 * b * h * s * s * hd)  # QK^T and PV over every pair
    head = 2 * b * d * cfg.vocab_size  # the last position only
    assert c.flops == cfg.n_layers * (linears + attn) + head
    assert c.kernel_calls == {}
    assert ids.shape == (b,) and ids.is_meta
    assert len(caches) == 1 and len(caches[0]) == cfg.n_layers
    assert c.peak > 0 and c.bytes > 0


def _launches():
    return (mm_ops.mxfp4_matmul.launches, cim_ops.cim_linear.launches,
            fa_ops.flash_attention.launches,
            pops.paged_flash_decode.launches,
            pops.paged_flash_decode_mx.launches,
            dict(mm_ops.mxfp4_matmul.route_launches),
            dict(cim_ops.cim_linear.route_launches),
            dict(fa_ops.flash_attention.route_launches))


def _check_meta(run, cpu_args, name, route, cost):
    """``run`` on the CPU and on meta copies of its inputs: the same
    shape and dtype, one call of ``name`` on ``route`` with ``cost``'s
    bytes and operations, no launch counted."""
    want = run(*cpu_args)
    before = _launches()
    with CostCounter() as c:
        got = run(*_meta(list(cpu_args)))
    assert got.is_meta and got.shape == want.shape
    assert got.dtype == want.dtype
    assert c.kernel_calls == {name: {route: 1}}
    n_bytes, ops, _ = cost
    assert (c.kernel_bytes, c.kernel_flops) == (n_bytes, ops)
    assert _launches() == before
    return c


@pytest.mark.parametrize("m,dtype,route", [
    (4, torch.bfloat16, "mma"), (64, torch.bfloat16, "wgmma"),
    (64, torch.float32, "fma"), (4, torch.bfloat16, "fma")])
def test_mxfp4_matmul_meta_branch(m, dtype, route):
    gen = torch.Generator().manual_seed(0)
    k, n = 256, (258 if route == "fma" and dtype == torch.bfloat16 else 384)
    w = torch.randn((k, n), generator=gen)
    packed = backends._quantize_packed(w)
    x = torch.randn((m, k), generator=gen).to(dtype)
    n_run = n + (-n % 4)  # the kernel's padded width
    c = _check_meta(lambda x, c_, e_: mm_ops.mxfp4_matmul(x, c_, e_),
                    (x, packed["codes"], packed["exps"]), "mxfp4_matmul",
                    route, mm_ops.cost(m, k, n_run, x.element_size()))
    if route == "wgmma" and mm_ops.pick_tc_splits(m, k, n) > 1:
        assert c.peak >= 4 * m * n * mm_ops.pick_tc_splits(m, k, n)


@pytest.mark.parametrize("m,route", [(4, "splitk"), (64, "wgmma")])
def test_cim_linear_meta_branch(m, route):
    gen = torch.Generator().manual_seed(1)
    k, n = 128, 1088
    w = mxlib.quantize_w(torch.randn((k, n), generator=gen))
    cal = cimlib.LayerCalib(torch.tensor(0, dtype=torch.int32),
                            torch.tensor(1.0e6))
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    assert cim_ops.pick_route(m, k, n) == route
    _check_meta(lambda x, w_, cal_: cim_ops.cim_linear(x, w_, cal_),
                (x, w, cal), "cim_linear", route,
                cim_ops.cost(m, k, n, x.element_size()))


@pytest.mark.parametrize("d,dtype,route", [
    (64, torch.bfloat16, "wgmma"), (80, torch.bfloat16, "fma"),
    (64, torch.float32, "fma")])
def test_flash_attention_meta_branch(d, dtype, route):
    gen = torch.Generator().manual_seed(2)
    b, sq, h, hkv, window = 1, 40, 4, 2, 16
    q = torch.randn((b, sq, h, d), generator=gen).to(dtype)
    k = torch.randn((b, sq, hkv, d), generator=gen).to(dtype)
    v = torch.randn((b, sq, hkv, d), generator=gen).to(dtype)
    pairs = fa_ops.visible_pairs(sq, sq, True, window, 0)
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sq)[None, :]
    assert pairs == int(((kp <= qp) & (kp > qp - window)).sum())
    assert fa_ops.visible_pairs(8, 8, False, 0, 0) == 64
    _check_meta(lambda q, k, v: fa_ops.flash_attention(
        q, k, v, causal=True, window=window), (q, k, v), "flash_attention",
        route, fa_ops.cost(b, sq, sq, h, hkv, d, q.element_size(), pairs))


@pytest.mark.parametrize("mx", [False, True])
def test_paged_decode_meta_branches(mx):
    gen = torch.Generator().manual_seed(3)
    lanes, hkv, g, dh, w, pool = 3, 2, 2, 32, 64, 5
    kv = (torch.randn((pool, w, 2 * hkv, dh), generator=gen)
          ).to(torch.bfloat16)
    q = mxlib.fake_quant(torch.randn((lanes, hkv, g, dh), generator=gen)
                         ).to(torch.bfloat16)
    rows = torch.tensor([4, 0, 2])
    lengths = torch.tensor([0, 33, 64])
    if mx:
        quant = layout.quant_page_full(*layout.split_kv(kv))
        cost = pops.cost_mx([w] * lanes, hkv, g, dh,
                            quant["kv_codes"].shape[-1],
                            quant["k_exps"].shape[-1])
        _check_meta(lambda q, quant, r, ln: pops.ragged_paged_decode(
            q, r, ln, quant=quant, scale=dh ** -0.5),
            (q, quant, rows, lengths), "paged_decode_mx", "default", cost)
    else:
        _check_meta(lambda q, kv, r, ln: pops.ragged_paged_decode(
            q, r, ln, kv=kv, scale=dh ** -0.5), (q, kv, rows, lengths),
            "paged_decode", "default", pops.cost_float([w] * lanes, hkv, g,
                                                       dh))


def test_mxfp4_wonly_steps_launch_by_the_formula():
    layers = 2
    cfg = dataclasses.replace(C.ARCHS["starcoder2-7b"], n_layers=layers)
    pre = steps.make_prefill_step(cfg, ONE, C.Shape(64, 1, "prefill"),
                                  device="meta")
    dec = steps.make_decode_step(cfg, ONE, C.Shape(64, 4, "decode"),
                                 device="meta")
    with CostCounter() as cp:
        pre.fn(*pre.args)
    with CostCounter() as cd:
        ids, _ = dec.fn(*dec.args)
    assert cp.kernel_calls == {"mxfp4_matmul": {"wgmma": 6 * layers}}
    assert cd.kernel_calls == {"mxfp4_matmul": {"mma": 6 * layers + 1}}
    assert ids.dtype == torch.int32 and ids.shape == (4,)
    # a prefill past dense_attn_max takes kernel E on meta, as on the card
    long = steps.make_prefill_step(cfg, ONE, C.Shape(4096, 1, "prefill"),
                                   device="meta")
    with CostCounter() as cl:
        long.fn(*long.args)
    assert cl.kernel_calls["flash_attention"] == {"wgmma": layers}


def test_roofline_terms_arithmetic():
    t = rl.roofline_terms({"flops": 989e12, "bytes accessed": 6.7e12}, None,
                          256)
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(2.0)
    assert t["dominant"] == "memory" and t["t_collective_s"] is None
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert t["hlo_flops_per_dev"] == 989e12
    assert t["hlo_bytes_per_dev"] == 6.7e12
    coll = rl.CollectiveStats()
    coll.add("collective-permute", 8.0)
    t = rl.roofline_terms({"flops": 2e12}, coll, 1)
    assert t["dominant"] == "compute" and t["roofline_fraction"] == 1.0
    assert t["collective_wire_bytes_per_dev"] == 8.0
    assert t["collective_by_kind"] == {
        "collective-permute": {"count": 1, "wire_bytes": 8.0}}


# the reference's result keys (launch/dryrun.py) without its compile
# times, which the port replaces by build_s / count_s, and with
# fits_80GB for fits_16GB
KEYS = {"arch", "shape", "mesh", "n_devices", "quant", "build_s", "count_s",
        "memory", "model_flops_global", "useful_flops_ratio", "t_compute_s",
        "t_memory_s", "t_collective_s", "dominant", "hlo_flops_per_dev",
        "hlo_bytes_per_dev", "collective_wire_bytes_per_dev",
        "collective_by_kind", "roofline_fraction", "k_micro", "details",
        "wholegraph", "kernel_calls", "per_device", "prediction"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
               "temp_bound", "fits_80GB"}
FAMILIES = ["h2o-danube-1.8b", "mixtral-8x22b", "hubert-xlarge",
            "zamba2-1.2b", "xlstm-125m", "qwen2-vl-7b"]


def _tiny_overrides(arch):
    cfg = C.ARCHS[arch]
    tiny = C.tiny(cfg)
    return {f.name: getattr(tiny, f.name)
            for f in dataclasses.fields(cfg)
            if getattr(tiny, f.name) != getattr(cfg, f.name)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_tiny_each_kind(arch):
    cfg = C.tiny(C.ARCHS[arch])
    kinds = ["train", "prefill"] + (["decode"] if cfg.supports_decode
                                    else [])
    for kind in kinds:
        shape = C.Shape(64, 4, kind)
        r = dryrun.run_cell(arch, shape, False, verbose=False,
                            overrides=_tiny_overrides(arch), mesh=ONE)
        assert set(r) == KEYS and set(r["memory"]) == MEMORY_KEYS, kind
        assert r["mesh"] == "1x1" and r["n_devices"] == 1
        mem = r["memory"]
        assert mem["temp_bound"] == "exact" and mem["temp_bytes"] > 0
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert r["hlo_flops_per_dev"] > 0 and r["hlo_bytes_per_dev"] > 0
        assert r["t_collective_s"] is None
        # (at tiny widths 2 N D may exceed the count: N holds the
        # embedding table, which a gather reads without a FLOP)
        assert r["useful_flops_ratio"] > 0, kind
        if kind == "train":
            assert {"stem_head", "optimizer", "weight_quant"} <= set(
                r["details"])
        bundle = steps.make_step(cfg, ONE, shape, device="meta")
        assert mem["argument_bytes"] == sum(
            t.numel() * t.element_size()
            for t in _leaves(bundle.args))
    # without the composition: the whole-step run's terms
    whole = dryrun.run_cell(arch, shape, False, verbose=False,
                            overrides=_tiny_overrides(arch), mesh=ONE,
                            blockwise=False)
    assert whole["details"] == {} and "wholegraph" not in whole
    assert {k: whole[k] for k in r["wholegraph"]} == r["wholegraph"]


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def test_run_cell_full_size_train_on_the_pod():
    r = dryrun.run_cell("h2o-danube-1.8b", "train_4k", False, verbose=False)
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    assert r["k_micro"] == 8 and r["memory"]["temp_bound"] == "upper"
    assert 0.5 < r["useful_flops_ratio"] <= 1.0
    assert r["dominant"] in ("compute", "memory")
    assert {"attn_n24", "stem_head", "optimizer",
            "weight_quant"} == set(r["details"])


def test_dryrun_cli_writes_results(tmp_path):
    out = tmp_path / "r.json"
    results = dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                           "--mesh", "both", "--out", str(out)])
    assert [r["mesh"] for r in results] == ["16x16", "2x16x16"]
    assert json.loads(out.read_text())[1]["n_devices"] == 512
