"""The partial (o, lse) mode of the port's paged decode kernels' plain
versions and wrappers, and the flash-decoding combine over a page's
blocks (``distributed.seq_parallel.combine_partials``), on the CPU,
against the JAX reference's dense decode (``repro.kernels.paged_attention
.ref.ragged_paged_decode_ref``) on the same bits.

- One block: the partial o cast to the page dtype is bitwise the whole
  decode's output, float pages and the MXFP4 mirrors; combined alone it
  is that output again, bitwise (its weight is 1).
- A page of 256 slots cut in 2 and 4 blocks, each block's partial at its
  own chunk width (``pick_bk``), combined in block order: against the
  dense function, SQNR at least the whole-page decode's less 1 dB (under
  the mirrors P is quantized per chunk against the running max, so a
  block's partial is no piece of the whole page's sum: the whole-page
  decode's own distance from the dense function is the bound); float
  pages also >= 40 dB against the whole-page decode.
- A lane with no live slot in a block has lse ``-inf`` and o 0; a lane
  empty in every block gives zeros.
- The owner mask of ``layout.quant_page_step`` (a rank's block of a pool
  whose sequence is cut): the owners' lanes bitwise the reference's
  update of the whole page, the others untouched.
- The wrapper: ``meta`` gives both shapes and records the f32 output's
  bytes. On the card: ``tests/test_torch_paged_partial_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import mx as jmx  # noqa: E402
from repro.kernels.paged_attention import layout as jlayout  # noqa: E402
from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.distributed import seq_parallel as spl  # noqa: E402
from repro_torch.kernels.paged_attention import layout as tlayout  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.obs import cost as cost_mod  # noqa: E402

j_decode_ref = jax.jit(jref.ragged_paged_decode_ref, static_argnames="scale")

P, HKV, G, DH, W = 5, 2, 3, 64, 256
SCALE = DH ** -0.5
ROWS = np.array([4, 0, 2, 1])
LENGTHS = ([0, 1, 100, 256], [256, 200, 37, 129])
BLOCKS = (2, 4)
DROP_DB = 1.0  # combined blocks against the dense function: below whole
FLOAT_MIN_DB = 40.0  # float pages: combined blocks against the whole page


def _bf16(a: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) with identical bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j).view(np.int16)).view(torch.bfloat16)
    return j, t


def _sqnr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / err))


def _case(seed: int, mx: bool):
    """q and the pages (float: fused bf16 kv; mx: q fake-quantized and the
    mirrors), each as (jax, torch) with the same bits."""
    rng = np.random.default_rng(seed)
    k, v, q = (rng.standard_normal(s).astype(np.float32) * 0.7
               for s in ((P, W, HKV, DH), (P, W, HKV, DH),
                         (len(ROWS), HKV, G, DH)))
    (kj, kt), (vj, vt), (qj, qt) = _bf16(k), _bf16(v), _bf16(q)
    if not mx:
        return (qj, {"kv": jlayout.fuse_kv(kj, vj)},
                qt, {"kv": tlayout.fuse_kv(kt, vt)})
    qj = jax.jit(jmx.fake_quant)(qj).astype(jnp.bfloat16)
    qt = tmx.fake_quant(qt)
    return (qj, {"quant": jax.jit(jlayout.quant_page_full)(kj, vj)},
            qt, {"quant": tlayout.quant_page_full(kt, vt)})


def _block(pages: dict, r: int, wl: int) -> dict:
    """Block ``r`` of ``wl`` slots of the pages (the V exponents' slot
    blocks with it)."""
    if "kv" in pages:
        return {"kv": pages["kv"][:, r * wl:(r + 1) * wl].contiguous()}
    q = pages["quant"]
    return {"quant": {
        "kv_codes": q["kv_codes"][:, r * wl:(r + 1) * wl].contiguous(),
        "k_exps": q["k_exps"][:, r * wl:(r + 1) * wl].contiguous(),
        "v_exps": q["v_exps"][:, r * wl // 32:(r + 1) * wl // 32]
        .contiguous()}}


def _blocks(q, pages, lengths: torch.Tensor, n: int):
    """Each block's partial (lengths clamped to it), stacked in order."""
    wl = W // n
    os, ls = [], []
    for r in range(n):
        lens = torch.clamp(lengths - r * wl, 0, wl).to(torch.int32)
        o, lse = tops.ragged_paged_decode(
            q, torch.from_numpy(ROWS), lens, scale=SCALE, partial=True,
            **_block(pages, r, wl))
        assert o.dtype == lse.dtype == torch.float32
        os.append(o)
        ls.append(lse)
    return torch.stack(os), torch.stack(ls)


@pytest.mark.parametrize("mx", [False, True], ids=["float", "mx"])
@pytest.mark.parametrize("lens", LENGTHS, ids=["a", "b"])
def test_one_block_partial_is_the_whole_output(mx, lens):
    _, _, q, pages = _case(1, mx)
    lengths = torch.tensor(lens, dtype=torch.int32)
    whole = tops.ragged_paged_decode(q, torch.from_numpy(ROWS), lengths,
                                     scale=SCALE, **pages)
    o, lse = tops.ragged_paged_decode(q, torch.from_numpy(ROWS), lengths,
                                      scale=SCALE, partial=True, **pages)
    assert torch.equal(o.to(whole.dtype).view(torch.int16),
                       whole.view(torch.int16))
    live = lengths > 0
    assert bool(torch.isfinite(lse[live]).all())
    assert bool((lse[~live] == float("-inf")).all())
    assert bool((o[~live] == 0).all())
    one = spl.combine_partials(o[None], lse[None], whole.dtype)
    assert torch.equal(one.view(torch.int16), whole.view(torch.int16))


@pytest.mark.parametrize("mx", [False, True], ids=["float", "mx"])
@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("lens", LENGTHS, ids=["a", "b"])
def test_blocks_combined_against_dense(mx, n, lens):
    qj, pj, q, pages = _case(2, mx)
    lengths = torch.tensor(lens, dtype=torch.int32)
    live = np.asarray(lens) > 0
    dense = np.asarray(j_decode_ref(
        qj, jnp.asarray(ROWS), jnp.asarray(lens), scale=SCALE, **pj),
        np.float32)[live]
    whole = tops.ragged_paged_decode(q, torch.from_numpy(ROWS), lengths,
                                     scale=SCALE, **pages)
    o, lse = _blocks(q, pages, lengths, n)
    got = spl.combine_partials(o, lse, whole.dtype)
    assert got.dtype == whole.dtype
    whole_np = whole.float().numpy()[live]
    got_np = got.float().numpy()
    assert _sqnr_db(dense, got_np[live]) >= _sqnr_db(dense, whole_np) \
        - DROP_DB
    if not mx:
        assert _sqnr_db(whole_np, got_np[live]) >= FLOAT_MIN_DB
    np.testing.assert_array_equal(got_np[~live], 0.0)


@pytest.mark.parametrize("mx", [False, True], ids=["float", "mx"])
def test_empty_blocks_and_lanes(mx):
    """Lane 0 has length 0, lane 1 lives in block 0 only: block 1's lse is
    -inf and its o 0 for both, and the combine gives lane 0 zeros and
    lane 1 its block-0 output."""
    _, _, q, pages = _case(3, mx)
    lengths = torch.tensor([0, 30, 200, 256], dtype=torch.int32)
    o, lse = _blocks(q, pages, lengths, 2)
    assert bool((lse[1, :2] == float("-inf")).all())
    assert bool((o[1, :2] == 0).all())
    assert bool((lse[0, 0] == float("-inf")).all())
    got = spl.combine_partials(o, lse)
    assert not bool(torch.isnan(got.float()).any())
    assert bool((got[0] == 0).all())
    assert torch.equal(got[1].view(torch.int16),
                       o[0, 1].to(torch.bfloat16).view(torch.int16))


def test_quant_page_step_owner_mask():
    """Two lanes' rows written into a pool, then the mirrors updated with
    a mask that keeps lane 1 out: lane 0's row and V block bitwise the
    reference's update, lane 1's mirrors as they were (its raw row was
    written too, as a non-owner's never is: the mask alone keeps it)."""
    rng = np.random.default_rng(4)
    k, v = (rng.standard_normal((P, 64, HKV, DH)).astype(np.float32) * 0.7
            for _ in range(2))
    (kj, kt), (vj, vt) = _bf16(k), _bf16(v)
    jq = jax.jit(jlayout.quant_page_full)(kj, vj)
    tq = tlayout.quant_page_full(kt, vt)
    before = {n: t.clone() for n, t in tq.items()}
    new = rng.standard_normal((2, 2 * HKV, DH)).astype(np.float32)
    jnew, tnew = _bf16(new)
    rows, slot = np.array([1, 3]), np.array([40, 7])
    jkv = jlayout.fuse_kv(kj, vj).at[rows, slot].set(jnew)
    tkv = tlayout.fuse_kv(kt, vt)
    tkv[torch.from_numpy(rows), torch.from_numpy(slot)] = tnew
    jout = jax.jit(jlayout.quant_page_step)(jq, jkv, jnp.asarray(rows[:1]),
                                            jnp.asarray(slot[:1]))
    tlayout.quant_page_step(tq, tkv, torch.from_numpy(rows),
                            torch.from_numpy(slot),
                            write=torch.tensor([True, False]))
    for name in ("kv_codes", "k_exps", "v_exps"):
        np.testing.assert_array_equal(tq[name].numpy(),
                                      np.asarray(jout[name]))
        assert torch.equal(tq[name][3], before[name][3])


@pytest.mark.parametrize("mx", [False, True], ids=["float", "mx"])
def test_meta_shapes_and_cost(mx):
    _, _, q, pages = _case(5, mx)
    qm = q.to("meta")
    pm = ({"kv": pages["kv"].to("meta")} if not mx else
          {"quant": {k: t.to("meta") for k, t in pages["quant"].items()}})
    with cost_mod.CostCounter() as cc:
        o, lse = tops.ragged_paged_decode(
            qm, torch.from_numpy(ROWS).to("meta"),
            torch.zeros(len(ROWS), dtype=torch.int32, device="meta"),
            scale=SCALE, partial=True, **pm)
        whole = tops.ragged_paged_decode(
            qm, torch.from_numpy(ROWS).to("meta"),
            torch.zeros(len(ROWS), dtype=torch.int32, device="meta"),
            scale=SCALE, **pm)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert lse.shape == q.shape[:-1] and lse.dtype == torch.float32
    assert whole.shape == q.shape and whole.dtype == torch.bfloat16
    heads = len(ROWS) * HKV * G
    args = [W] * len(ROWS), HKV, G, DH
    if mx:
        args += (pages["quant"]["kv_codes"].shape[-1],
                 pages["quant"]["k_exps"].shape[-1])
    cost = tops.cost_mx if mx else tops.cost_float
    extra = cost(*args, partial=True)[0] - cost(*args)[0]
    assert extra == heads * (4 * DH + 4) - 2 * heads * DH
    assert cc.kernel_bytes == 2 * cost(*args)[0] + extra
