"""The port's tiled online-softmax attention against the JAX reference.

The plain version of the ``flash_attention`` kernel (the naive oracle) is
held against the JAX ``flash_attention_ref`` and the Pallas kernel in
interpret mode at the shapes, masks and bounds of ``tests/test_kernels.py``:
2e-5 in f32 (sums in another order), 3e-2 in bf16 with ``q_offset``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfa_ref  # noqa: E402

j_ref = jax.jit(jfa_ref.flash_attention_ref,
                static_argnames=("causal", "window", "q_offset"))


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _qkv(seed, b, sq, sk, h, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(shape), dtype) for shape in
                 ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))


@pytest.mark.parametrize("sq,sk,h,hkv,d", [
    (32, 32, 4, 4, 16),
    (64, 64, 8, 2, 32),
    (33, 48, 4, 1, 16),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_plain_matches_reference_and_pallas_interpret(sq, sk, h, hkv, d,
                                                      causal, window):
    # causal with sq < sk: the queries are the last sq positions
    off = sk - sq if causal else 0
    q, k, v = _qkv(sq + h + window, 2, sq, sk, h, hkv, d, jnp.float32)
    got = tfa_ops.flash_attention(*map(_to_torch, (q, k, v)), causal=causal,
                                  window=window, q_offset=off)
    assert got.shape == (2, sq, h, d) and got.dtype == torch.float32
    for ref in (j_ref(q, k, v, causal=causal, window=window, q_offset=off),
                jfa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                        q_offset=off, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


def test_bf16_with_q_offset():
    """q is the last 16 positions of a 64-long sequence."""
    q, k, v = _qkv(1, 1, 16, 64, 4, 4, 32, jnp.bfloat16)
    got = tfa_ops.flash_attention(*map(_to_torch, (q, k, v)), causal=True,
                                  q_offset=48)
    assert got.dtype == torch.bfloat16
    for ref in (j_ref(q, k, v, causal=True, q_offset=48),
                jfa_ops.flash_attention(q, k, v, causal=True, q_offset=48,
                                        interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=3e-2,
                                   atol=3e-2)


def test_wrapper_contract():
    """CPU tensors run the plain version (no launch counted); a query row
    with no visible key is zero; another device or a GQA mismatch raise."""
    q, k, v = map(_to_torch, _qkv(2, 1, 8, 8, 4, 2, 16, jnp.float32))
    before = tfa_ops.flash_attention.launches
    out = tfa_ops.flash_attention(q, k, v, causal=True, window=2,
                                  q_offset=-4)
    assert tfa_ops.flash_attention.launches == before
    np.testing.assert_array_equal(out[:, :4].numpy(), 0.0)  # keys all future
    np.testing.assert_array_equal(
        out.numpy(), tfa_ref.flash_attention_ref(q, k, v, causal=True,
                                                 window=2,
                                                 q_offset=-4).numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        tfa_ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="does not match"):
        tfa_ops.flash_attention(q[:, :, :3], k, v)


@pytest.mark.parametrize("d,dtype,route", [
    (64, torch.bfloat16, "wgmma"),
    (128, torch.bfloat16, "wgmma"),
    (128, torch.float32, "fma"),
    (32, torch.bfloat16, "fma"),
    (96, torch.bfloat16, "fma"),
])
def test_pick_route(d, dtype, route):
    """bf16 with a head_dim of whole 64-value tiles takes the tensor cores;
    f32 (rounding it would change the function) and other head_dims stay
    on the fma kernel, whatever the lengths."""
    for sq, sk in ((1, 1), (129, 300), (2048, 2048)):
        assert tfa_ops.pick_route(sq, sk, d, dtype) == route


# sq, sk, heads, KV heads, head_dim, causal, window, q_offset
_CUDA_CASES = [
    (100, 100, 8, 2, 64, True, 0, 0),
    (70, 200, 8, 2, 64, True, 0, 130),
    (129, 129, 8, 2, 64, True, 40, 0),
    (33, 48, 8, 2, 64, False, 0, 0),
    # starcoder2-7b heads (G = 9); lengths that are no multiple of 64 or 128
    (200, 200, 36, 4, 128, True, 0, 0),
    (150, 333, 36, 4, 128, True, 0, 183),
    (300, 300, 36, 4, 128, True, 100, 0),
    (130, 330, 36, 4, 128, True, 70, 200),
    (97, 161, 36, 4, 128, False, 0, 0),
    (64, 256, 8, 2, 32, True, 0, 192),  # bf16 D=32: the fma route
    # rows that see no key: 13..15 here (keys end at 47), all of them below
    (16, 48, 8, 2, 64, True, 16, 50),
    (16, 48, 8, 2, 128, True, 16, 100),
]


def _no_key_rows(sq, sk, causal, window, q_offset):
    qp = np.arange(sq)[:, None] + q_offset
    kp = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    return ~m.any(axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,h,hkv,d,causal,window,q_offset", _CUDA_CASES)
def test_cuda_kernel_matches_plain_version(dtype, sq, sk, h, hkv, d, causal,
                                           window, q_offset):
    """The CUDA kernel against its plain version on the card: ragged
    tiles, GQA, masks relative to q_offset, on the route pick_route names;
    f32 sums in another order (bf16: one output ulp, and P rounded to bf16
    on the wgmma route). Rows that see no key are exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = (t.to(dtype).cuda() for t in map(_to_torch, _qkv(
        sq + sk, 2, sq, sk, h, hkv, d, jnp.float32)))
    route = tfa_ops.pick_route(sq, sk, d, dtype)
    before = tfa_ops.flash_attention.launches
    before_route = tfa_ops.flash_attention.route_launches[route]
    got = tfa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    assert tfa_ops.flash_attention.launches == before + 1
    assert tfa_ops.flash_attention.route_launches[route] == before_route + 1
    ref = tfa_ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    dead = torch.from_numpy(_no_key_rows(sq, sk, causal, window, q_offset))
    assert bool((got[:, dead.cuda()] == 0).all())
