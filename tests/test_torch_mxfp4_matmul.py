"""The port's packed-MXFP4 dequant-matmul and weight-only backend against
the JAX reference.

- The plain version of the ``mxfp4_matmul`` kernel against the JAX
  ``mxfp4_matmul_ref`` and the Pallas kernel in interpret mode, at the
  shapes and the bound of ``tests/test_kernels.py`` (rtol 2e-2, atol
  2e-2 * max|ref|): f32 sums taken in another order.
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4608, 512), (4, 2048, 1024),
                                   (33, 96, 48), (192, 512, 640)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain_version(m, k, n, dtype):
    """The CUDA kernel against its plain version on the card: ragged M,
    split K (M <= 4) and a floor block; f32 sums in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, codes, exps = _packed(m + k, k, n)
    tc = _to_torch(codes).cuda()
    te = _to_torch(_floor_exps(np.asarray(exps))).cuda()
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(
        dtype).cuda()
    before = tmm_ops.mxfp4_matmul.launches
    got = tmm_ops.mxfp4_matmul(x, tc, te)
    assert tmm_ops.mxfp4_matmul.launches == before + 1
    ref = tmm_ref.mxfp4_matmul_ref(x, tc, te).float()
    torch.testing.assert_close(got.float(), ref, rtol=2e-2,
                               atol=2e-2 * float(ref.abs().max()))

