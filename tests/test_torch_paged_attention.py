"""The port's fused paged KV layout and ragged paged decode against the
JAX reference.

- Layout: the fused MXFP4 mirrors from ``quant_page_full`` and the
  in-place ``quant_page_step`` update, and the page dequantizers, are
  bitwise the reference's.
- Dense reference: the port's ``ragged_paged_decode_ref`` against JAX's
  on the same mirrors. Not bitwise: the score and PV sums are f32 sums
  taken in another order by the two frameworks, and after the bf16 score
  round a one-ulp difference can flip one P code, which moves one output
  element by one P step times |v|. Bound: SQNR > 40 dB and atol 0.05.
- Chunked plain version of the CUDA kernel against the Pallas
  ``paged_flash_decode_mx`` in interpret mode at the same ``bk``, with
  W=48 / bk=32 (clamped tail chunk) and lengths 0, 1, 31, 32, 33 and W.
  Same bound and reason. It is also held to the dense reference at the
  reference's own kernel bound (SQNR > 13 dB, atol 0.35): per-chunk vs
  whole-axis P quantization.
- Float pages: the chunked plain version of the float CUDA kernel
  (``paged_flash_decode_ref``) against the Pallas ``paged_flash_decode``
  in interpret mode at W=48 / bk=32 on the reference's pinned ragged
  lengths, at atol 1e-2. The Pallas source rounds each chunk's PV to
  bf16, but XLA folds that round trip away (an f32 dot), so neither side
  rounds it: the measured maximum difference is 0 on these pages (with
  the round, 1 bf16 ulp on about a fifth of the outputs). Against
  the dense reference it holds the reference's own kernel bound (atol
  0.04, rtol 0.05). The float CUDA kernel splits each lane's keys over
  blocks (``pick_splits``); the split rule covers every live key once.
- The mx CUDA kernel splits a lane's query heads over blocks
  (``pick_heads``): the plain version run per head group and concatenated
  is bitwise the whole call, since each head has its own softmax state
  and P blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import mx as jmx  # noqa: E402
from repro.kernels.paged_attention import kernel as jkernel  # noqa: E402
from repro.kernels.paged_attention import layout as jlayout  # noqa: E402
from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.paged_attention import layout as tlayout  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402

# one compiled graph per reference function (eager JAX compiles op by op)
j_decode_ref = jax.jit(jref.ragged_paged_decode_ref, static_argnames="scale")
j_fake_quant = jax.jit(jmx.fake_quant)

P, HKV, G, DH = 5, 2, 3, 32
SCALE = DH ** -0.5
LENGTHS = {48: ([0, 1, 31, 48], [32, 33, 47, 0]), 64: ([64, 1, 33, 0],)}
FLOAT_LENGTHS = ([0, 1, 32, 48], [33, 47, 31, 0], [48, 48, 1, 17])


def _bf16(a: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) with identical bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j).view(np.int16)).view(torch.bfloat16)
    return j, t


def _bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _pages(seed: int, w: int, lanes: int = 4):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, w, HKV, DH)).astype(np.float32) * 0.7
    v = rng.standard_normal((P, w, HKV, DH)).astype(np.float32) * 0.7
    q = rng.standard_normal((lanes, HKV, G, DH)).astype(np.float32) * 0.7
    return _bf16(k), _bf16(v), _bf16(q)


def _quant_both(k, v):
    jq = jax.jit(jlayout.quant_page_full)(k[0], v[0])
    tq = tlayout.quant_page_full(k[1], v[1])
    return jq, tq


def _sqnr_db(ref, got) -> float:
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _assert_close(got, ref, live, sqnr_min, atol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert _sqnr_db(ref[live], got[live]) > sqnr_min
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0.0)
    np.testing.assert_array_equal(got[~live], 0.0)


@pytest.mark.parametrize("w", [48, 64])
def test_quant_page_full_and_dequant_bitwise(w):
    k, v, _ = _pages(0, w)
    jq, tq = _quant_both(k, v)
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]))
    np.testing.assert_array_equal(
        _bits(tlayout.dequant_k_pages(tq["kv_codes"], tq["k_exps"], DH)),
        _bits(jax.jit(jlayout.dequant_k_pages, static_argnums=2)(
            jq["kv_codes"], jq["k_exps"], DH)))
    np.testing.assert_array_equal(
        _bits(tlayout.dequant_v_pages(tq["kv_codes"], tq["v_exps"], DH)),
        _bits(jax.jit(jlayout.dequant_v_pages, static_argnums=2)(
            jq["kv_codes"], jq["v_exps"], DH)))
    kv = tlayout.fuse_kv(k[1], v[1])
    np.testing.assert_array_equal(_bits(kv), _bits(jlayout.fuse_kv(k[0], v[0])))
    ks, vs = tlayout.split_kv(kv)
    np.testing.assert_array_equal(_bits(ks), _bits(k[1]))
    np.testing.assert_array_equal(_bits(vs), _bits(v[1]))


@pytest.mark.parametrize("w", [48, 50])
def test_quant_page_step_bitwise_in_place(w):
    """Write one new row per lane into the pool, then update the mirrors
    in place: bitwise the reference's functional update (W=50 has a
    partial trailing 32-slot block)."""
    k, v, _ = _pages(1, w)
    jq, tq = _quant_both(k, v)
    rng = np.random.default_rng(2)
    new = rng.standard_normal((3, 2 * HKV, DH)).astype(np.float32)
    jnew, tnew = _bf16(new)
    rows, slot = np.array([4, 0, 2]), np.array([w - 1, 0, 33])
    jkv = jlayout.fuse_kv(k[0], v[0]).at[rows, slot].set(jnew)
    tkv = tlayout.fuse_kv(k[1], v[1])
    tkv[torch.from_numpy(rows), torch.from_numpy(slot)] = tnew
    jout = jax.jit(jlayout.quant_page_step)(jq, jkv, jnp.asarray(rows),
                                            jnp.asarray(slot))
    tlayout.quant_page_step(tq, tkv, torch.from_numpy(rows),
                            torch.from_numpy(slot))
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jout[name]))


@pytest.mark.parametrize("w", [48, 64])
def test_dense_ref_matches_reference(w):
    k, v, q = _pages(3, w)
    jq, tq = _quant_both(k, v)
    qmx_j = j_fake_quant(q[0]).astype(jnp.bfloat16)
    qmx_t = tmx.fake_quant(q[1])
    np.testing.assert_array_equal(_bits(qmx_t), _bits(qmx_j))
    rows = np.array([4, 0, 2, 1])
    for lens in LENGTHS[w]:
        lens = np.array(lens)
        ref = j_decode_ref(
            qmx_j, jnp.asarray(rows), jnp.asarray(lens), quant=jq, scale=SCALE)
        got = tref.ragged_paged_decode_ref(
            qmx_t, torch.from_numpy(rows), torch.from_numpy(lens), quant=tq,
            scale=SCALE)
        _assert_close(got.float(), ref, lens > 0, 40.0, 0.05)
    # float pages: the same dense function without quantization
    kvj, kvt = jlayout.fuse_kv(k[0], v[0]), tlayout.fuse_kv(k[1], v[1])
    lens = np.array(LENGTHS[w][0])
    ref = j_decode_ref(q[0], jnp.asarray(rows), jnp.asarray(lens), kv=kvj,
                       scale=SCALE)
    got = tref.ragged_paged_decode_ref(q[1], torch.from_numpy(rows),
                                       torch.from_numpy(lens), kv=kvt,
                                       scale=SCALE)
    _assert_close(got.float(), ref, lens > 0, 40.0, 0.05)


@pytest.mark.parametrize("w", [48, 64])
def test_chunked_plain_matches_pallas_interpret(w):
    """The CUDA kernel's plain version against the Pallas kernel it
    replaces, at the reference's chunk width (W=48 -> bk=32: the tail chunk
    is fetched at the clamped offset 16 and its overlap masked)."""
    k, v, q = _pages(4, w)
    jq, tq = _quant_both(k, v)
    bk = tops.pick_bk(w)
    assert bk == jops.pick_bk(w)
    qmx_j = j_fake_quant(q[0]).astype(jnp.bfloat16)
    qmx_t = tmx.fake_quant(q[1])
    rows = np.array([4, 0, 2, 1])
    for lens in LENGTHS[w]:
        lens = np.array(lens)
        ref = jkernel.paged_flash_decode_mx(
            qmx_j, jq["kv_codes"], jq["k_exps"], jq["v_exps"],
            jnp.asarray(rows, jnp.int32), jnp.asarray(lens, jnp.int32),
            scale=SCALE, bk=bk, interpret=True)
        got = tops.ragged_paged_decode(
            qmx_t, torch.from_numpy(rows), torch.from_numpy(lens), quant=tq,
            scale=SCALE)
        _assert_close(got.float(), ref, lens > 0, 40.0, 0.05)
        dense = tref.ragged_paged_decode_ref(
            qmx_t, torch.from_numpy(rows), torch.from_numpy(lens), quant=tq,
            scale=SCALE)
        _assert_close(got.float(), dense.float(), lens > 0, 13.0, 0.35)


def test_float_chunked_plain_matches_pallas_interpret():
    """The float-page CUDA kernel's plain version against the Pallas
    kernel it replaces (W=48 -> bk=32: clamped tail chunk at offset 16),
    and against the dense reference; zero-length lanes exactly zero."""
    k, v, q = _pages(7, 48)
    kvj, kvt = jlayout.fuse_kv(k[0], v[0]), tlayout.fuse_kv(k[1], v[1])
    rows = np.array([4, 0, 2, 1])
    assert tops.pick_bk(48) == 32
    for lens in FLOAT_LENGTHS:
        lens = np.array(lens)
        ref = jkernel.paged_flash_decode(
            q[0], kvj, jnp.asarray(rows, jnp.int32),
            jnp.asarray(lens, jnp.int32), scale=SCALE, bk=32, interpret=True)
        got = tops.ragged_paged_decode(
            q[1], torch.from_numpy(rows), torch.from_numpy(lens), kv=kvt,
            scale=SCALE)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   atol=1e-2, rtol=0.0)
        dense = tref.ragged_paged_decode_ref(
            q[1], torch.from_numpy(rows), torch.from_numpy(lens), kv=kvt,
            scale=SCALE)
        np.testing.assert_allclose(got, dense.float().numpy(), atol=0.04,
                                   rtol=0.05)
        np.testing.assert_array_equal(got[lens == 0], 0.0)


def test_pick_bk_and_wrapper_contract():
    for w in (8, 31, 32, 48, 100, 256, 1024):
        assert tops.pick_bk(w) == jops.pick_bk(w)
    k, v, q = _pages(5, 48)
    tq = tlayout.quant_page_full(k[1], v[1])
    kv = tlayout.fuse_kv(k[1], v[1])
    rows = torch.zeros(4, dtype=torch.int32)
    lens = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        tops.ragged_paged_decode(q[1], rows, lens, scale=SCALE)
    before = (tops.paged_flash_decode.launches,
              tops.paged_flash_decode_mx.launches)
    for pages in ({"quant": tq}, {"kv": kv}):
        out = tops.ragged_paged_decode(q[1], rows, lens, scale=SCALE, **pages)
        assert out.shape == q[1].shape and out.dtype == torch.bfloat16
        with pytest.raises(ValueError, match="unsupported device"):
            tops.ragged_paged_decode(q[1].to("meta"), rows, lens,
                                     scale=SCALE, **pages)
    # CPU: the plain versions, no launch counted
    assert (tops.paged_flash_decode.launches,
            tops.paged_flash_decode_mx.launches) == before


@pytest.mark.parametrize("w", [48, 64, 256, 4096, 16384])
def test_pick_splits_covers_every_live_key_once(w):
    """The float kernel's key split: at most 64 keys and 256 splits a
    lane, more than one split on these pages, and for lengths 0, 1, a
    split edge +- 1 and W the live slots of the splits (``split_slots``,
    the kernel's own rule) are [0, length), each exactly once."""
    sw, ns = tops.pick_splits(w)
    assert 1 <= sw <= min(64, w) and ns == -(-w // sw) and 1 < ns <= 256
    for length in sorted({0, 1, sw - 1, sw, sw + 1, w - 1, w}):
        slots = [p for s in range(ns)
                 for p in tops.split_slots(w, sw, s, length)]
        assert slots == list(range(length))
        for s in range(ns):  # a split's fetch stays inside the page
            assert 0 <= min(s * sw, w - sw) <= w - sw
    assert tops.pick_splits(8) == (8, 1)
    with pytest.raises(ValueError, match="splits"):
        tops.pick_splits(256 * 64 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [48, 256])
def test_cuda_float_kernel_matches_plain_version(w):
    """The float-page CUDA kernel against its plain version on the card,
    lengths at the key splits' edges included: each split takes its own
    max and the combine rescales, so P rounds to bf16 against another max
    (a bf16 ulp of the output at most)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    k, v, q = _pages(8, w)
    kv = tlayout.fuse_kv(k[1], v[1]).cuda()
    qc = q[1].cuda()
    rows = torch.tensor([4, 0, 2, 1], dtype=torch.int32).cuda()
    sw, _ = tops.pick_splits(w)
    edges = [sw - 1, sw, sw + 1, w - 1]
    for lens in (FLOAT_LENGTHS + (edges,) if w == 48
                 else ([0, 31, 129, 256], edges)):
        lens = torch.tensor(lens, dtype=torch.int32).cuda()
        before = tops.paged_flash_decode.launches
        got = tops.ragged_paged_decode(qc, rows, lens, kv=kv, scale=SCALE)
        assert tops.paged_flash_decode.launches == before + 1
        ref = tref.paged_flash_decode_ref(qc, kv, rows, lens, scale=SCALE,
                                          bk=tops.pick_bk(w))
        _assert_close(got.float().cpu(), ref.float().cpu(),
                      (lens > 0).cpu().numpy(), 40.0, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [48, 64])
def test_cuda_kernel_matches_plain_version(w):
    """The CUDA kernel against its plain version on the card; bound as
    above (f32 sums in another order, one P code flip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    k, v, q = _pages(6, w)
    tq = {n: t.cuda() for n, t in tlayout.quant_page_full(k[1], v[1]).items()}
    qmx = tmx.fake_quant(q[1]).cuda()
    rows = torch.tensor([4, 0, 2, 1], dtype=torch.int32).cuda()
    for lens in LENGTHS[w]:
        lens = torch.tensor(lens, dtype=torch.int32).cuda()
        got = tops.ragged_paged_decode(qmx, rows, lens, quant=tq, scale=SCALE)
        ref = tref.paged_flash_decode_mx_ref(
            qmx, tq["kv_codes"], tq["k_exps"], tq["v_exps"], rows, lens,
            scale=SCALE, bk=tops.pick_bk(w))
        _assert_close(got.float().cpu(), ref.float().cpu(),
                      (lens > 0).cpu().numpy(), 40.0, 0.05)


@pytest.mark.parametrize("heads", [1, 2, 4, 9])
def test_mx_head_groups_are_the_whole_call(heads):
    """The mx kernel's head split, in plain torch: at G = 9 query heads per
    KV head, the chunked plain version run on each group of ``heads``
    heads and concatenated is bitwise the whole call (W = 48: a clamped
    tail chunk; lengths 0, 1, 33, 48)."""
    g = 9
    rng = np.random.default_rng(heads)
    k, v = (_bf16(rng.standard_normal((P, 48, HKV, DH)).astype(np.float32)
                  * 0.7)[1] for _ in range(2))
    q = tmx.fake_quant(_bf16(rng.standard_normal((4, HKV, g, DH))
                             .astype(np.float32) * 0.7)[1])
    tq = tlayout.quant_page_full(k, v)
    rows = torch.tensor([4, 0, 2, 1], dtype=torch.int32)
    lens = torch.tensor([0, 1, 33, 48], dtype=torch.int32)

    def run(qh):
        return tref.paged_flash_decode_mx_ref(
            qh, tq["kv_codes"], tq["k_exps"], tq["v_exps"], rows, lens,
            scale=SCALE, bk=tops.pick_bk(48))

    whole = run(q)
    parts = torch.cat([run(q[:, :, h0:h0 + heads])
                       for h0 in range(0, g, heads)], dim=2)
    np.testing.assert_array_equal(_bits(parts), _bits(whole))
    assert tops.pick_heads(g) <= tops.G_MAX and tops.pick_heads(2) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("w", [48, 64, 256])
@pytest.mark.parametrize("heads", [None, 1, 4])
def test_cuda_kernel_at_the_serve_shape(w, heads):
    """The mx CUDA kernel at starcoder2-7b's decode shape (G = 9 query heads
    per KV head, head_dim 128, 4 KV heads) on the smoke's lengths, with
    the picked head groups and with 1 and 4 heads a block: within SQNR >
    40 dB and atol 0.05 of its plain version, within 13 dB and 0.35 of
    the dense reference, exact zeros on the empty lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hkv, g, dh = 4, 9, 128
    lens = {48: [0, 1, 33, 48], 64: [64, 1, 33, 0], 256: [0, 31, 129, 256]}[w]
    rng = np.random.default_rng(w)
    k, v = (torch.from_numpy(rng.standard_normal((10, w, hkv, dh))
                             .astype(np.float32) * 0.7).to(torch.bfloat16)
            for _ in range(2))
    q = tmx.fake_quant(torch.from_numpy(
        rng.standard_normal((4, hkv, g, dh)).astype(np.float32) * 0.7)
        .to(torch.bfloat16)).cuda()
    tq = {n: t.cuda() for n, t in tlayout.quant_page_full(k, v).items()}
    rows = torch.tensor([7, 0, 3, 9], dtype=torch.int32).cuda()
    lengths = torch.tensor(lens, dtype=torch.int32).cuda()
    scale = dh ** -0.5
    before = tops.paged_flash_decode_mx.launches
    got = (tops._launch_mx(q, tq, rows, lengths, scale, tops.pick_bk(w),
                           heads=heads) if heads else
           tops.ragged_paged_decode(q, rows, lengths, quant=tq, scale=scale))
    assert tops.paged_flash_decode_mx.launches == before + 1
    ref = tref.paged_flash_decode_mx_ref(
        q, tq["kv_codes"], tq["k_exps"], tq["v_exps"], rows, lengths,
        scale=scale, bk=tops.pick_bk(w))
    dense = tref.ragged_paged_decode_ref(q, rows, lengths, quant=tq,
                                         scale=scale)
    live = (lengths > 0).cpu().numpy()
    got, ref, dense = (t.float().cpu().numpy() for t in (got, ref, dense))
    _assert_close(got, ref, live, 40.0, 0.05)
    _assert_close(got, dense, live, 13.0, 0.35)
