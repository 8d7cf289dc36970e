"""The arithmetic of the port's split-K CIM kernel, pinned on the CPU.

``csrc/cim_linear.cu`` sums each block's aligned term as an integer in
units of 2^-CM (``s << shift``), in any order, and gives the rows whose
bound ``12 * 2^CM * sum |code_x|`` reaches 2^24 the ordered f32 walk. A
test-local int64 model of that arithmetic (random K splits summed in a
shuffled order, the same shift mapping and guard) must be bitwise the
port's plain version (``repro_torch.core.cim.cim_linear``) and within
rtol/atol 1e-5 of the JAX reference, the bound the reference keeps between
its own kernel and its simulation (``tests/test_kernels.py``). A
constructed row whose ordered f32 sum rounds shows why the guard exists.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cim as jcim  # noqa: E402
from repro.core import mx as jmx  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import cim as tcim  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.cim_linear import ops as tcim_ops  # noqa: E402

CFGS = [(10, 3, True), (None, 2, False), (8, 4, True)]
DEAD = 1024  # the kernel's shift past both windows


def _row_shift_base(a: torch.Tensor) -> torch.Tensor:
    """E_X - E_N with the float extremes of 2^(E_X - E_N) moved past the
    windows: it is 0 at or below -150 and inf at or above 128."""
    return torch.where(a <= -150, -DEAD, torch.where(a >= 128, DEAD, a))


def _shifts(t: torch.Tensor, cm: int):
    """(pass-1 shift or None, pass-2 shift or None) of t = E_X + E_W - E_N
    as the kernel takes them: the term is s << shift in units of 2^-CM."""
    live1 = t >= -cm
    live2 = (t >= -2 * cm) & (t < -cm)
    sh1 = (cm + torch.clamp(t, max=0)).clamp(0, cm)
    sh2 = (t + 2 * cm).clamp(0, cm)
    return live1, sh1, live2, sh2


def _int_sums(x, w: tmx.MXW, e_n: int, cm: int, rng):
    """Integer pass sums [M, N] (int64, units of 2^-CM) over random
    32-aligned K splits added in a shuffled order, and sum |code_x| a row."""
    k, n = w.codes.shape
    nb = k // 32
    xq = tmx.quantize(x.float()[..., :k])
    cx = xq.codes.reshape(-1, nb, 32).long()
    s = torch.einsum("mbi,bin->mbn", cx, w.codes.long().reshape(nb, 32, n))
    t = (_row_shift_base(xq.exps.long() - e_n)[:, :, None]
         + w.exps.long()[None])
    live1, sh1, live2, sh2 = _shifts(t, cm)
    term1 = torch.where(live1, s << sh1, 0)
    term2 = torch.where(live2, s << sh2, 0)
    cuts = np.sort(rng.choice(np.arange(1, nb), size=min(nb - 1, 5),
                              replace=False)) if nb > 1 else []
    bounds = [0, *cuts.tolist(), nb] if len(cuts) else [0, nb]
    parts = [(term1[:, a:b].sum(1), term2[:, a:b].sum(1))
             for a, b in zip(bounds[:-1], bounds[1:])]
    i1 = torch.zeros_like(parts[0][0])
    i2 = torch.zeros_like(i1)
    for j in rng.permutation(len(parts)):
        i1, i2 = i1 + parts[j][0], i2 + parts[j][1]
    return i1, i2, cx.abs().sum((1, 2))


def _guarded(rowsum: torch.Tensor, k: int, cm: int) -> torch.Tensor:
    if not tcim_ops.needs_guard(k, cm):
        return torch.zeros_like(rowsum, dtype=torch.bool)
    return 12 * 2 ** cm * rowsum >= tcim_ops.EXACT_UNITS


def int_model(x, w: tmx.MXW, calib: tcim.LayerCalib, cfg: tcim.CIMConfig,
              seed: int = 0) -> torch.Tensor:
    """The kernel's function: integer sums read out through the plain
    version's ADC and scales, guarded rows through the ordered walk."""
    cm = cfg.cm_bits
    i1, i2, rowsum = _int_sums(x, w, int(calib.e_n), cm,
                               np.random.default_rng(seed))
    unit = 2.0 ** -cm
    y = (tcim._adc(i1.float() * unit, calib.adc_fs, cfg.adc_bits)
         * tcim._en_scale(calib.e_n) * 0.25)
    if cfg.two_pass:
        y = y + (tcim._adc(i2.float() * unit, calib.adc_fs, cfg.adc_bits)
                 * tcim._en_scale(calib.e_n, cm) * 0.25)
    g = _guarded(rowsum, w.codes.shape[0], cm)
    if g.any():
        y[g] = tcim.cim_linear(x[g], w, cfg, calib)[0]
    return y.float()


def rounding_case(n: int = 8, cm: int = 3):
    """K = 18432: row 0 has 460 32-blocks with every product 12 * 12 at
    shift CM (36864 units each, 16.96 M in all, past 2^24) and then 116
    blocks of one product 1 * 1 at t = -CM (1 unit each), so the ordered
    f32 sum drops the small terms (half an ulp, ties to even) where the
    integer sum keeps them; row 1 is the same with the big blocks at a
    quarter, inside the guard. Returns (x f32 [2, K], w K-major, calib)."""
    k, big = 18432, 460
    nb = k // 32
    x = np.zeros((2, k), np.float32)
    x[0, :big * 32] = 6.0  # codes 12, E_X = 0
    x[1, :big * 32:4] = 6.0  # a quarter of them
    x[:, big * 32::32] = 6.0  # small blocks: code 12 then code 1
    x[:, big * 32 + 1::32] = 0.5
    codes = np.zeros((k, n), np.int8)
    codes[:big * 32] = 12
    codes[big * 32 + 1::32] = 1
    exps = np.zeros((nb, n), np.int8)
    exps[big:] = -cm  # t = -CM for the small blocks
    w = tmx.MXW(tmx.kmajor(torch.from_numpy(codes)),
                tmx.kmajor(torch.from_numpy(exps)))
    calib = tcim.LayerCalib(e_n=torch.tensor(0, dtype=torch.int32),
                            adc_fs=torch.tensor(1.0e7))
    return torch.from_numpy(x), w, calib


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m", [1, 13, 192])
@pytest.mark.parametrize("k", [96, 4608])
@pytest.mark.parametrize("adc,cm,two", CFGS)
def test_int_model_matches_plain_and_reference(m, k, adc, cm, two):
    n = 40
    x, w = _case(m, k, n, m + k + cm)
    tcfg = tcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    jcfg = jcim.CIMConfig(adc_bits=adc, cm_bits=cm, two_pass=two)
    tw = tmx.quantize_w(torch.from_numpy(w))
    tcal = tcim.calibrate_rowhist([torch.from_numpy(x)], tw, tcfg)
    plain, _ = tcim.cim_linear(torch.from_numpy(x), tw, tcfg, tcal)
    got = int_model(torch.from_numpy(x), tw, tcal, tcfg, seed=m + k)
    assert torch.equal(got, plain)
    jw = jmx.quantize_w(jnp.asarray(w))
    jcal = jcim.calibrate_rowhist([jnp.asarray(x)], jw, jcfg)
    ref, _ = jax.jit(jcim.cim_linear, static_argnums=2)(
        jnp.asarray(x), jw, jcfg, jcal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("two", [True, False])
def test_rounding_row_is_guarded(two):
    """Past 2^24 units the ordered f32 sum rounds: the integer sum differs
    from it, the guard flags that row only, and the guarded model is the
    plain version again."""
    x, w, calib = rounding_case()
    cfg = tcim.CIMConfig(adc_bits=None, cm_bits=3, two_pass=two)
    k = w.codes.shape[0]
    assert tcim_ops.needs_guard(k, cfg.cm_bits)
    i1, _, rowsum = _int_sums(x, w, 0, cfg.cm_bits, np.random.default_rng(1))
    xq = tmx.quantize(x)
    c1, _, _ = tcim._scan_blocks(
        xq.codes.reshape(2, -1, 32).float(), xq.exps.int(), w, calib.e_n, cfg)
    exact = i1.double() * 2.0 ** -cfg.cm_bits
    assert (c1[0].double() != exact[0]).all()  # the f32 walk rounded
    assert torch.equal(c1[1].double(), exact[1])  # inside the guard: exact
    assert _guarded(rowsum, k, cfg.cm_bits).tolist() == [True, False]
    plain, _ = tcim.cim_linear(x, w, cfg, calib)
    assert torch.equal(int_model(x, w, calib, cfg), plain)


@pytest.mark.parametrize("cm", [2, 3, 4])
def test_shift_mapping_matches_pow2_wide(cm):
    """Every (E_X - E_N, E_W) the kernel can meet: the integer shift gives
    the plain version's factors, 0 and inf of 2^(E_X - E_N) included."""
    a = torch.arange(-300, 300, dtype=torch.int64)[:, None]
    ew = torch.arange(-128, 128, dtype=torch.int64)[None, :]
    uv = tmx.exp2i(a) * tmx.exp2i(ew)
    lo, lo2 = 2.0 ** -cm, 2.0 ** -(2 * cm)
    under1 = uv < lo
    f1 = torch.where(under1, 0.0, torch.clamp(uv, max=1.0)).double()
    f2 = torch.where(under1 & (uv >= lo2), uv * 2.0 ** cm, 0.0).double()
    live1, sh1, live2, sh2 = _shifts(_row_shift_base(a) + ew, cm)
    unit = 2.0 ** -cm
    assert torch.equal(f1, torch.where(live1, 2.0 ** sh1.double() * unit, 0.0))
    assert torch.equal(f2, torch.where(live2, 2.0 ** sh2.double() * unit, 0.0))


@pytest.mark.parametrize("case", ["zero_calibration", "e_x_minus_e_n_near_-130"])
def test_e_n_extremes(case):
    """An all-zero calibration batch gives E_N = -10^6 (2^(E_X - E_N) is
    inf: every block at factor 1); activation blocks at E_X = -127 against
    weights at E_W ~ 125 under E_N = 3 give E_X - E_N = -130 (a subnormal
    2^(E_X - E_N) that E_W brings back into the pass-2 window). The integer
    sums are the plain version's f32 sums, and the outputs agree."""
    rng = np.random.default_rng(3)
    m, k, n = 6, 128, 24
    cfg = tcim.CIMConfig(adc_bits=None)
    if case == "zero_calibration":
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = tmx.quantize_w(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32)))
        calib = tcim.calibrate_rowhist([torch.zeros((2, k))], w, cfg)
        assert int(calib.e_n) == -10 ** 6
    else:
        x = (rng.uniform(-1.9, 1.9, (m, k)) * 2.0 ** -125).astype(np.float32)
        wf = rng.standard_normal((k, n)).astype(np.float32)
        wf[:, ::2] = rng.uniform(-1.0, 1.0, (k, n // 2)) * 2.0 ** 127
        w = tmx.quantize_w(torch.from_numpy(wf))
        calib = tcim.LayerCalib(torch.tensor(3, dtype=torch.int32),
                                torch.tensor(1.0))
        assert int(tmx.quantize(torch.from_numpy(x)).exps.min()) - 3 == -130
    xt = torch.from_numpy(x)
    i1, i2, _ = _int_sums(xt, w, int(calib.e_n), cfg.cm_bits,
                          np.random.default_rng(2))
    xq = tmx.quantize(xt)
    c1, c2, _ = tcim._scan_blocks(xq.codes.reshape(m, -1, 32).float(),
                                  xq.exps.int(), w, calib.e_n, cfg)
    unit = 2.0 ** -cfg.cm_bits
    assert torch.equal(c1, i1.float() * unit)
    assert torch.equal(c2, i2.float() * unit)
    if case != "zero_calibration":
        assert bool((c2 != 0).any())  # the window was reached
    plain, _ = tcim.cim_linear(xt, w, cfg, calib)
    assert torch.isfinite(plain).all()
    assert torch.equal(int_model(xt, w, calib, cfg), plain)


SHAPES = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608),
          (4608, 49152), (96, 200), (640, 200), (32, 8), (18432, 8)]


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 13, 192])
def test_pick_splits_covers_k(m, k, n):
    """Splits none empty, covering K once on 32-aligned bounds, each at
    least one 32-block a K-warp; at decode every starcoder2-7b shape gets a
    grid of at least two blocks an SM and at most one wave."""
    nb = k // 32
    splits = tcim_ops.pick_splits(m, k, n)
    per = -(-nb // splits)  # the kernel's division
    bounds = [(s * per, min(nb, (s + 1) * per)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == nb
    assert all(a < b for a, b in bounds)  # no empty split
    assert all(b == c for (_, b), (c, _) in zip(bounds[:-1], bounds[1:]))
    bm, wk = tcim_ops.pick_tile(m, n)
    assert splits == 1 or per >= wk
    tiles = -(-m // bm) * -(-n // (256 // wk))
    if m <= 16 and (k, n) in SHAPES[:5]:  # starcoder2-7b at decode
        assert 2 * tcim_ops.SMS <= tiles * splits <= tcim_ops.TARGET_BLOCKS
    assert tcim_ops.workspace_ints(m, k, n) == (
        0 if splits == 1 else 2 * m * n + -(-n // (256 // wk)) * (m + -(-m // bm)))


@pytest.mark.parametrize("m,k,n,route", [
    (4, 4608, 18432, "splitk"), (63, 4608, 18432, "splitk"),
    (64, 4608, 18432, "wgmma"), (192, 18432, 4608, "wgmma"),
    (192, 4608, 512, "splitk"), (192, 4608, 1024, "splitk"),
    (192, 4608, 1025, "wgmma"), (192, 96, 2048, "splitk"),
    (192, 4608, 49152, "wgmma")])
def test_pick_route(m, k, n, route):
    """The tensor-core route from TC_MIN_M rows, on K % 64 == 0 and more
    than 1024 columns; everything else splits K."""
    assert tcim_ops.pick_route(m, k, n) == route


def test_needs_guard_threshold():
    assert not tcim_ops.needs_guard(14563, 3)
    assert tcim_ops.needs_guard(14564, 3)
    assert not tcim_ops.needs_guard(4608, 4)
    assert tcim_ops.needs_guard(18432, 2) == (18432 * 144 * 4 >= 2 ** 24)


def test_quantize_w_is_kmajor_and_plain_unchanged():
    rng = np.random.default_rng(5)
    k, n = 96, 40
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((7, k)).astype(np.float32))
    tw = tmx.quantize_w(w)
    assert tw.codes.shape == (k, n) and tw.codes.stride() == (1, k)
    assert tw.exps.shape == (k // 32, n) and tw.exps.stride() == (1, k // 32)
    dense = tmx.MXW(tw.codes.contiguous(), tw.exps.contiguous())
    jw = jmx.quantize_w(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.exps.numpy(), np.asarray(jw.exps))
    cfg = tcim.CIMConfig()
    cal = tcim.calibrate_rowhist([x], tw, cfg)
    assert cal == tcim.calibrate_rowhist([x], dense, cfg)
    assert torch.equal(tcim.cim_linear(x, tw, cfg, cal)[0],
                       tcim.cim_linear(x, dense, cfg, cal)[0])


def test_from_reference_keeps_cim_nodes_kmajor():
    codes = np.arange(64 * 3, dtype=np.int8).reshape(64, 3) % 12
    node = {"codes": codes, "exps": np.zeros((2, 3), np.int8),
            "e_n": np.int32(1), "adc_fs": np.float32(2.0)}
    tree = {"head": dict(node), "segments": [{"attn": {
        "ln": {"gamma": np.ones(4, np.float32)}, "wq": dict(node)}}]}
    out = from_reference(tree, device="cpu")
    for got in (out["head"], out["segments"][0][0]["attn"]["wq"]):
        assert got["codes"].stride() == (1, 64)
        assert got["exps"].stride() == (1, 2)
        np.testing.assert_array_equal(got["codes"].numpy(), codes)
    assert out["segments"][0][0]["attn"]["ln"]["gamma"].shape == (4,)
