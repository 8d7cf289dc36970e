"""The port's packed-MXFP4 dequant-matmul and weight-only backend against
the JAX reference.

- The plain version of the ``mxfp4_matmul`` kernel against the JAX
  ``mxfp4_matmul_ref`` and the Pallas kernel in interpret mode, at the
  shapes and the bound of ``tests/test_kernels.py`` (rtol 2e-2, atol
  2e-2 * max|ref|): f32 sums taken in another order.
- Routes: :func:`pick_route` (bf16 decode lanes on the warp-level ``mma``
  route, bf16 prefill on the ``wgmma`` route, f32 x on ``fma``) and the
  tensor-core routes' K splits. Every dequantized weight is exactly a bf16
  value, bit for bit, which makes both bf16 tensor-core routes the
  reference's function.
- The ``mma`` route's arithmetic, modelled in numpy: its m16n8k16 fragment
  mapping (every code byte of a K block in exactly one lane's register,
  the warp's products exactly ``x @ W``), its code-pair table times the
  block scale (bitwise ``_dequant_packed``, the E8M0 flush included) and
  its in-launch split-K finish (bitwise the two-pass sum, whatever the
  arrival order).
- Bitwise: ``dequant_ref``, ``_dequant_packed``, ``_quantize_packed`` and
  ``convert_params_mxfp4`` (on tiny starcoder2-7b, carried by
  ``from_reference``). At the E8M0 floor (biased exponent 0 or 1) the
  reference's scale is a subnormal that its platforms flush to zero; the
  port writes that flush out, so a floor block with nonzero codes
  dequantizes to zeros on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mx as jmx  # noqa: E402
from repro.kernels.mxfp4_matmul import ops as jmm_ops  # noqa: E402
from repro.kernels.mxfp4_matmul import ref as jmm_ref  # noqa: E402
from repro.layers import backends as jbackends  # noqa: E402
from repro.layers import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ops as tmm_ops  # noqa: E402
from repro_torch.kernels.mxfp4_matmul import ref as tmm_ref  # noqa: E402
from repro_torch.layers import backends as tbackends  # noqa: E402
from repro_torch.layers import common as tcommon  # noqa: E402
from repro_torch.layers.common import RunCtx, linear_apply  # noqa: E402

j_mm_ref = jax.jit(jmm_ref.mxfp4_matmul_ref)
j_dequant = jax.jit(jmm_ref.dequant_ref)
j_dequant_packed = jax.jit(jbackends._dequant_packed)
j_quantize_packed = jax.jit(jbackends._quantize_packed)
FLOOR = (0, 1)  # biased E8M0 exponents whose reference scale flushes to 0


def _to_torch(a) -> torch.Tensor:
    """A jax / numpy array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    """Bit patterns of a float torch tensor or jax array (bf16 or f32)."""
    if torch.is_tensor(a):
        a = a.contiguous()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.int32)


def _packed(seed: int, k: int, n: int):
    """Packed codes / biased exps of a random weight, from the JAX side."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    p = j_quantize_packed(jnp.asarray(w))
    return w, p["codes"], p["exps"]


def _floor_exps(exps: np.ndarray) -> np.ndarray:
    """Put the first two K blocks of every column at the E8M0 floor."""
    e = np.array(exps)
    e[0], e[1] = FLOOR
    return e


@pytest.mark.parametrize("m,k,n", [(8, 64, 16), (128, 128, 128),
                                   (33, 96, 48), (256, 512, 64)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_reference_and_pallas_interpret(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + k + n)
    xj = jnp.asarray(rng.standard_normal((m, k)), getattr(jnp, dtype))
    _, codes, exps = _packed(m + k + n, k, n)
    got = tmm_ops.mxfp4_matmul(_to_torch(xj), _to_torch(codes),
                               _to_torch(exps))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    for ref in (j_mm_ref(xj, codes, exps),
                jmm_ops.mxfp4_matmul(xj, codes, exps, interpret=True)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got, ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())


def test_dequant_bitwise_including_e8m0_floor():
    """Every byte of codes, every biased exponent the quantizer can emit
    plus the floor: both dequantizers bitwise the reference's; a floor
    block with nonzero codes is all zeros."""
    k, n = 64, 256
    codes = np.arange(k // 2 * n, dtype=np.int64).reshape(k // 2, n) % 256
    codes = codes.astype(np.uint8)
    exps = np.stack([np.arange(n) % 253, (np.arange(n) * 7 + 3) % 253])
    exps[:, :4] = [[0, 1, 2, 3], [1, 0, 3, 2]]
    exps = exps.astype(np.uint8)
    tc, te = _to_torch(codes), _to_torch(exps)
    d_ref = tmm_ref.dequant_ref(tc, te)
    np.testing.assert_array_equal(_bits(d_ref),
                                  _bits(j_dequant(codes, exps)))
    d_bf = tbackends._dequant_packed(tc, te)
    assert d_bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(d_bf),
                                  _bits(j_dequant_packed(codes, exps)))
    floor = np.isin(exps, FLOOR)  # [K//32, N]
    blk = np.repeat(floor, 32, axis=0)
    assert (codes.view(np.uint8) & 0x77).any()  # nonzero codes there
    assert (d_ref.numpy()[blk] == 0).all() and (d_ref.numpy()[~blk] != 0).any()
    np.testing.assert_array_equal(d_bf.float().numpy(), d_ref.numpy())


def test_matmul_at_e8m0_floor_matches_pallas():
    """Activations only in the floor blocks: the Pallas kernel (interpret)
    and the plain version both give exact zeros; with all K blocks live
    they agree at the reference's bound."""
    k, n = 128, 64
    _, codes, exps = _packed(5, k, n)
    exps = jnp.asarray(_floor_exps(np.asarray(exps)))
    x = np.zeros((4, k), np.float32)
    x[:, :64] = np.random.default_rng(6).standard_normal((4, 64))
    for xs in (x, np.random.default_rng(7).standard_normal((4, k))
               .astype(np.float32)):
        ref = np.asarray(jmm_ops.mxfp4_matmul(jnp.asarray(xs), codes, exps,
                                              interpret=True), np.float32)
        got = tmm_ops.mxfp4_matmul(torch.from_numpy(xs), _to_torch(codes),
                                   _to_torch(exps)).float().numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    assert (ref != 0).any()
    zero = np.asarray(jmm_ops.mxfp4_matmul(jnp.asarray(x), codes, exps,
                                           interpret=True), np.float32)
    got = tmm_ops.mxfp4_matmul(torch.from_numpy(x), _to_torch(codes),
                               _to_torch(exps))
    np.testing.assert_array_equal(zero, 0.0)
    np.testing.assert_array_equal(got.float().numpy(), 0.0)


def test_quantize_packed_bitwise():
    """Packing along K, including blocks of tiny weights near the floor."""
    w = np.random.default_rng(8).standard_normal((96, 40)).astype(np.float32)
    w[:32, :5] *= 1e-37  # shared exponents at the bottom of the range
    jp = j_quantize_packed(jnp.asarray(w))
    tp = tbackends._quantize_packed(torch.from_numpy(w))
    for name in ("codes", "exps"):
        assert tp[name].dtype == torch.uint8 and tp[name].is_contiguous()
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    assert (np.asarray(jp["exps"]) <= 3).any()


def test_convert_params_mxfp4_bitwise_on_tiny_starcoder2():
    """The port's conversion of the float tree carried by
    ``from_reference`` is bitwise the reference's conversion carried the
    same way: packed codes / exps, the f32 bias kept, every other float
    leaf cast to bf16, the ``min_n`` gate."""
    jcfg = jconfigs.tiny(jconfigs.ARCHS["starcoder2-7b"])
    params, _ = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    for min_n in (32, 128):
        ref = from_reference(to_np(jax.jit(
            jcommon.convert_params_mxfp4, static_argnames="min_n")(
                params, min_n=min_n)), device="cpu")
        got = tcommon.convert_params_mxfp4(
            from_reference(to_np(params), device="cpu"), min_n=min_n)
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
        for (path, r), (_, g) in zip(flat_ref, flat_got):
            assert g.dtype == r.dtype, path
            if r.dtype == torch.bfloat16:
                r, g = r.view(torch.int16), g.view(torch.int16)
            assert torch.equal(g, r), path
        layer = got["segments"][0][1]
        # d_ff 96 outputs: packed at min_n 32, a bf16 float node at 128
        assert ("codes" in layer["ffn"]["w1"]) == (min_n == 32)
        assert layer["ffn"]["w1"].get("w", layer["ffn"]["w1"].get(
            "codes")).dtype == (torch.uint8 if min_n == 32 else torch.bfloat16)
        assert got["lm_head"]["exps"].shape == (jcfg.d_model // 32,
                                                jcfg.vocab_size)


def test_weight_only_backend_dispatch():
    """A packed node runs weight-only whatever ``ctx.quant`` says (the
    reference's marker order); ``impl="ref"`` is the reference's
    bf16-dequant matmul, ``impl="auto"`` the kernel wrapper; a float node
    under ``mxfp4_wonly`` is the plain bf16 matmul."""
    w = np.random.default_rng(9).standard_normal((64, 48)).astype(np.float32)
    x = _to_torch(jnp.asarray(np.random.default_rng(10)
                              .standard_normal((2, 3, 64)), jnp.bfloat16))
    node = tbackends.get_backend("mxfp4_wonly").convert(
        {"w": torch.from_numpy(w), "b": torch.full((48,), 0.25)})
    assert node["b"].dtype == torch.float32
    for quant in ("none", "mxfp4_wonly", "cim"):
        assert tbackends.resolve_backend(RunCtx(quant=quant), node).name == \
            "mxfp4_wonly"
    jnode = jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in node.items()})
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jcommon.linear_apply(
        jcommon.RunCtx(quant="mxfp4_wonly", shd=jcommon.ShardingCtx()), jnode,
        jx), np.float32)
    for impl in ("ref", "auto"):
        y = linear_apply(RunCtx(quant="mxfp4_wonly", impl=impl), node, x)
        assert y.shape == (2, 3, 48)
        np.testing.assert_allclose(y.float().numpy(), ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    dq = tbackends._dequant_packed(node["codes"], node["exps"])
    y = linear_apply(RunCtx(quant="mxfp4_wonly", impl="ref"), node, x)
    np.testing.assert_array_equal(
        y.float().numpy(),
        (torch.matmul(x, dq) + node["b"].to(torch.bfloat16)).float().numpy())
    f = {"w": torch.from_numpy(w)}
    np.testing.assert_array_equal(
        linear_apply(RunCtx(quant="mxfp4_wonly"), f, x).float().numpy(),
        linear_apply(RunCtx(quant="none"), f, x).float().numpy())


def test_wrapper_contract():
    """CPU tensors run the plain version (no launch counted), any leading
    dims; another device or mismatched shapes raise."""
    _, codes, exps = _packed(11, 64, 32)
    tc, te = _to_torch(codes), _to_torch(exps)
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    before = tmm_ops.mxfp4_matmul.launches
    y = tmm_ops.mxfp4_matmul(x, tc, te)
    assert y.shape == (2, 3, 32) and y.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        y.reshape(6, 32).float().numpy(),
        tmm_ref.mxfp4_matmul_ref(x.reshape(6, 64), tc, te).float().numpy())
    assert tmm_ops.mxfp4_matmul.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tmm_ops.mxfp4_matmul(x.to("meta"), tc.to("meta"), te.to("meta"))
    with pytest.raises(ValueError, match="does not match"):
        tmm_ops.mxfp4_matmul(x[..., :32], tc, te)
    assert tmm_ops.pick_splits(4, 4608, 4608) > 1
    assert tmm_ops.pick_splits(192, 4608, 49152) == 1


# (K, N) of the static linears at starcoder2-7b width: wq/wo, wk/wv, w1,
# w2, the LM head
STARCODER2_LINEARS = [(4608, 4608), (4608, 512), (4608, 18432),
                      (18432, 4608), (4608, 49152)]


@pytest.mark.parametrize("k,n", STARCODER2_LINEARS)
def test_pick_route(k, n):
    """bf16 decode lanes (M <= 4) take the mma route and f32 x keeps the
    fma route; bf16 x at the served prefill length takes the wgmma route
    on every linear."""
    for m in (1, 4):
        assert tmm_ops.pick_route(m, k, n, torch.bfloat16) == "mma"
        assert tmm_ops.pick_route(m, k, n, torch.float32) == "fma"
    assert tmm_ops.pick_route(192, k, n, torch.float32) == "fma"
    assert tmm_ops.pick_route(192, k, n, torch.bfloat16) == "wgmma"
    assert tmm_ops.pick_route(100, k, n, torch.bfloat16) == "wgmma"
    # shapes the tensor-core kernel does not tile stay on the fma route
    assert tmm_ops.pick_route(192, k + 32, n, torch.bfloat16) == "fma"
    assert tmm_ops.pick_route(192, k, n + 64, torch.bfloat16) == "fma"


@pytest.mark.parametrize("m", [16, 100, 192, 400])
@pytest.mark.parametrize("k,n", STARCODER2_LINEARS + [(512, 640),
                                                      (18432, 256)])
def test_pick_tc_splits_leaves_no_split_empty(m, k, n):
    """Every K split of the tensor-core route owns at least one 64-row
    tile and together they cover K once (the kernel's ceil division)."""
    splits = tmm_ops.pick_tc_splits(m, k, n)
    nkt = k // tmm_ops.TC_BK
    per = -(-nkt // splits)
    assert 1 <= splits <= nkt and (splits - 1) * per < nkt <= splits * per


def test_dequant_values_are_exact_in_bf16():
    """The premise of the tensor-core route: every dequantized weight (each
    nibble 0-15 under each biased exponent 0-255) is a bf16 value, bit for
    bit, including the b <= 1 flush and the infinities at the top
    exponents. The only exception is a zero code at b = 255 (0 x inf), NaN
    before and after the round."""
    rows = np.arange(16, dtype=np.uint8)
    codes = np.repeat((rows | (rows << 4))[:, None], 256, axis=1)  # [16, 256]
    exps = np.arange(256, dtype=np.uint8)[None, :]  # one 32-row block
    d = tmm_ref.dequant_ref(_to_torch(codes), _to_torch(exps))  # [32, 256]
    rounded = d.to(torch.bfloat16).float()
    differ = _bits(rounded) != _bits(d)
    nan = torch.isnan(d).numpy()
    nibble = np.repeat(rows, 2)[:, None] & 0x7  # |code| of each K row
    expected_nan = (nibble == 0) & (np.arange(256)[None, :] == 255)
    np.testing.assert_array_equal(nan, expected_nan)
    assert torch.isnan(rounded).numpy()[nan].all()
    np.testing.assert_array_equal(differ & ~nan, False)
    assert torch.isinf(d).any() and (d.numpy()[:, :2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4608, 512), (4, 2048, 1024),
                                   (33, 96, 48), (192, 512, 640),
                                   (192, 4608, 512), (100, 512, 640),
                                   (192, 18432, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain_version(m, k, n, dtype):
    """The CUDA kernel against its plain version on the card: ragged M,
    split K on both routes, and a floor block; f32 sums in another order.
    The route the shape and dtype pick is the one that launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, codes, exps = _packed(m + k, k, n)
    tc = _to_torch(codes).cuda()
    te = _to_torch(_floor_exps(np.asarray(exps))).cuda()
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(
        dtype).cuda()
    route = tmm_ops.pick_route(m, k, n, dtype)
    before = tmm_ops.mxfp4_matmul.launches
    routes = dict(tmm_ops.mxfp4_matmul.route_launches)
    got = tmm_ops.mxfp4_matmul(x, tc, te)
    assert tmm_ops.mxfp4_matmul.launches == before + 1
    routes[route] += 1
    assert tmm_ops.mxfp4_matmul.route_launches == routes
    ref = tmm_ref.mxfp4_matmul_ref(x, tc, te).float()
    torch.testing.assert_close(got.float(), ref, rtol=2e-2,
                               atol=2e-2 * float(ref.abs().max()))



@pytest.mark.parametrize("m", list(range(1, tmm_ops.TC_MIN_M + 2)))
def test_pick_route_by_rows(m):
    """bf16 below ``TC_MIN_M`` rows -> mma (within its two 8-row tiles), from
    there -> wgmma; f32 -> fma at every row count; N % 16 != 0 -> fma."""
    k, n = 4608, 18432
    want = "mma" if m < tmm_ops.TC_MIN_M else "wgmma"
    assert tmm_ops.pick_route(m, k, n, torch.bfloat16) == want
    assert tmm_ops.pick_route(m, k, n, torch.float32) == "fma"
    assert tmm_ops.pick_route(m, k, 40, torch.bfloat16) == "fma"
    assert tmm_ops.TC_MIN_M - 1 <= tmm_ops.MMA_MAX_M


@pytest.mark.parametrize("m", [1, 4, 15])
@pytest.mark.parametrize("k,n", STARCODER2_LINEARS + [(96, 48), (512, 640),
                                                      (18432, 256)])
def test_pick_mma_leaves_no_split_empty(m, k, n):
    """Every K split of the mma route owns at least one 32-row block, the
    splits cover K once (the kernel's ceil division), and the grid stays
    within one resident wave wherever K is split or two warps share a
    tile's columns."""
    wc, splits = tmm_ops.pick_mma(m, k, n)
    nkb = k // 32
    per = -(-nkb // splits)
    assert 1 <= splits <= nkb and (splits - 1) * per < nkb <= splits * per
    assert wc in (1, 2)
    tiles = -(-n // (tmm_ops.MMA_BN * wc))
    if splits > 1 or wc > 1:
        assert tiles * splits <= tmm_ops.mma_resident(m)


def _code_pairs() -> torch.Tensor:
    """The mma route's table: byte -> bf16 code values (2x the FP4 value)
    of its low and high nibble, [256, 2]."""
    from repro_torch.core import mx as tmx

    return torch.from_numpy(tmx.PAIR_TABLE.view(np.int32).copy()).view(
        torch.bfloat16).reshape(256, 2)


def _block_scale(b: np.ndarray) -> np.ndarray:
    """The mma route's block scale 2^(b-128) in f32: exponent field
    max(b - 1, 0), so 0 at the floor (b <= 1)."""
    field = np.maximum(b.astype(np.int64) - 1, 0).astype(np.uint32) << 23
    return field.view(np.float32)


def test_mma_widening_is_dequant_packed_bitwise():
    """Every byte under every exponent byte (the floor b <= 1 and the top
    b = 255 included): the code pair times the block scale, in f32 as the
    kernel scales its block sums, is bitwise ``_dequant_packed``."""
    b = np.arange(256).astype(np.uint8)
    codes = np.repeat(np.arange(256, dtype=np.uint8)[None, :], 16, 0)
    codes = np.repeat(codes, len(b), 1)  # [16, 256 * 256]: a block a column
    exps = np.repeat(b, 256)[None, :]
    want = tbackends._dequant_packed(torch.from_numpy(codes),
                                     torch.from_numpy(exps)).float().numpy()
    pairs = _code_pairs().float().numpy()[codes[0]]  # [256 * 256, 2]
    with np.errstate(over="ignore"):  # 12 x 2^127 is inf on both sides
        got = pairs * _block_scale(exps[0])[:, None]
    np.testing.assert_array_equal(got.view(np.int32),
                                  want[:2].T.copy().view(np.int32))
    zero = exps[0] <= 1
    assert (got[zero] == 0).all() and (got[~zero] != 0).any()


def _mma_warp_model(x, codes, exps):
    """The mma route's warp over one 128-column tile, lane by lane: each
    lane's 16-byte items (packed rows 4t..4t+3 of a 32-row block at columns
    16g..16g+15, the exponent row, x rows g and g + 8 at K 8t..8t+7), its
    A registers (code pairs) and B registers of the block's two k16 steps,
    m16n8k16 on the assembled tiles, the block sums times their columns'
    scales. Returns the product [M, 128] and, per code byte, how many
    registers took it."""
    m, k = x.shape
    tab = _code_pairs().float().numpy()
    taken = np.zeros((k // 2, 128), np.int64)
    out = np.zeros((16, 128))
    for kb in range(k // 32):
        scale = _block_scale(exps[kb]).astype(np.float64)  # [128]
        for mt in range(2):
            bs = np.zeros((8, 16, 8))  # [j, A row, B col]: the block sums
            for st in range(2):
                a = np.zeros((8, 16, 16))  # [j, row i, slot]
                b = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    xrow = g + 8 * mt
                    xv = (x[xrow, kb * 32 + 8 * t: kb * 32 + 8 * t + 8]
                          if xrow < m else np.zeros(8))
                    for half in range(2):  # b0 (slots 2t..), b1 (2t + 8..)
                        w = xv[4 * st + 2 * half: 4 * st + 2 * half + 2]
                        b[2 * t + 8 * half: 2 * t + 8 * half + 2, g] = w
                    for half in range(2):  # a0 / a1 (row 4t + 2st), a2 / a3
                        r = kb * 16 + 4 * t + 2 * st + half
                        for j in range(8):
                            for hi in range(2):  # A rows g, g + 8
                                c = 16 * g + 8 * hi + j
                                if mt == 0:
                                    taken[r, c] += 1
                                a[j, g + 8 * hi,
                                  2 * t + 8 * half: 2 * t + 8 * half + 2] = \
                                    tab[codes[r, c]]
                bs += a @ b  # exact: small integers and code values
            for j in range(8):
                for hi in range(2):
                    col = 16 * np.arange(8) + 8 * hi + j  # A rows 8hi..
                    out[8 * mt: 8 * mt + 8, col] += \
                        (bs[j, 8 * hi: 8 * hi + 8, :] * scale[col, None]).T
    return out[:m], taken


@pytest.mark.parametrize("m", [1, 4, 11])
def test_mma_fragment_model(m):
    """The mma route's fragment mapping: every (packed row, column) byte of
    a K block lands in exactly one lane's register, and the warp's block
    sums times the scales are exactly ``x @ dequant`` (integer x, so every
    sum is exact), rows past M included as zeros."""
    k = 64
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 256, (k // 2, 128)).astype(np.uint8)
    exps = rng.integers(120, 135, (k // 32, 128)).astype(np.uint8)
    exps[0, :3] = [0, 1, 2]  # the floor and the smallest live scale
    x = rng.integers(-3, 4, (m, k)).astype(np.float64)
    got, taken = _mma_warp_model(x, codes, exps)
    assert (taken == 1).all()
    w = tmm_ref.dequant_ref(torch.from_numpy(codes),
                            torch.from_numpy(exps)).double().numpy()
    np.testing.assert_array_equal(got, x @ w)


def _finish_splits(partial: np.ndarray, order) -> tuple[np.ndarray, int]:
    """The mma route's split-K finish as the kernel runs it: splits arrive
    in ``order``, each adds one to the tile's counter; the one that sees
    ``splits - 1`` sums every split's partial in split order and resets
    the counter. Returns (the f32 sum, the counter afterwards)."""
    splits = partial.shape[0]
    counter, out = 0, None
    for _ in order:
        arrived, counter = counter, counter + 1
        if arrived == splits - 1:
            out = np.zeros(partial.shape[1:], np.float32)
            for z in range(splits):
                out += partial[z]
            counter = 0
    return out, counter


@pytest.mark.parametrize("splits", [1, 2, 7, 9])
def test_mma_split_sum_is_the_two_pass_sum(splits):
    """Whatever order the splits arrive in, the last one's sum is bitwise
    the two-pass sum (``splitk_sum_kernel``: split order), and the counter
    is back at zero for the next launch."""
    rng = np.random.default_rng(splits)
    partial = (rng.standard_normal((splits, 4, 128))
               * 10.0 ** rng.integers(-6, 7, (splits, 4, 128))
               ).astype(np.float32)
    two_pass = np.zeros((4, 128), np.float32)
    for z in range(splits):
        two_pass = two_pass + partial[z]
    for _ in range(5):
        got, counter = _finish_splits(partial, rng.permutation(splits))
        assert counter == 0
        np.testing.assert_array_equal(got.view(np.int32),
                                      two_pass.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", list(range(1, tmm_ops.TC_MIN_M)))
@pytest.mark.parametrize("k,n", [(4608, 512), (2048, 1024), (512, 640),
                                 (96, 48), (18432, 256)])
def test_cuda_mma_route_matches_plain_version(m, k, n):
    """The mma route against the plain version on the card at every row
    count it takes, one and two 8-row tiles, with a floor block; split K
    (the in-launch finish) on the narrow shapes. Bound as the other
    routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, codes, exps = _packed(m * k + n, k, n)
    tc = _to_torch(codes).cuda()
    te = _to_torch(_floor_exps(np.asarray(exps))).cuda()
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(
        torch.bfloat16).cuda()
    assert tmm_ops.pick_route(m, k, n, x.dtype) == "mma"
    before = tmm_ops.mxfp4_matmul.route_launches["mma"]
    got = tmm_ops.mxfp4_matmul(x, tc, te).float()
    assert tmm_ops.mxfp4_matmul.route_launches["mma"] == before + 1
    ref = tmm_ref.mxfp4_matmul_ref(x, tc, te).float()
    torch.testing.assert_close(got, ref, rtol=2e-2,
                               atol=2e-2 * float(ref.abs().max()))
    # the same again: the split finish left its counters at zero
    torch.testing.assert_close(tmm_ops.mxfp4_matmul(x, tc, te).float(), got,
                               rtol=0, atol=0)
