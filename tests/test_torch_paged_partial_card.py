"""Kernels B and D in their partial (o, lse) mode on the card, against
their plain versions (``kernels/paged_attention/ref.py``, ``partial=True``)
on random pages at W 256, and the launch counted in
``partial_launches``. This file imports no JAX: its ``cuda``-marked tests
run on the card (the CPU tests of the partial mode, against the JAX
reference, are ``tests/test_torch_paged_partial.py``).
"""

import pytest

torch = pytest.importorskip("torch")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro_torch.core import mx as tmx  # noqa: E402
from repro_torch.kernels.paged_attention import layout as tlayout  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402

P, HKV, G, DH, W = 5, 2, 3, 64, 256
SCALE = DH ** -0.5
ROWS = (4, 0, 2, 1)
LENGTHS = (256, 200, 37, 129)


def _case(seed: int, mx: bool):
    """q and the pages on the card (mx: q fake-quantized and the
    mirrors)."""
    gen = torch.Generator().manual_seed(seed)
    k, v = (torch.randn((P, W, HKV, DH), generator=gen) * 0.7
            for _ in range(2))
    q = torch.randn((len(ROWS), HKV, G, DH), generator=gen) * 0.7
    k, v, q = (t.to(torch.bfloat16).cuda() for t in (k, v, q))
    if not mx:
        return q, {"kv": tlayout.fuse_kv(k, v)}
    return tmx.fake_quant(q), {"quant": tlayout.quant_page_full(k, v)}


@pytest.mark.cuda
@pytest.mark.parametrize("mx", [False, True], ids=["float", "mx"])
def test_cuda_partial_matches_plain_version(mx):
    """Each kernel's partial mode against its plain version (o: B within
    1e-5 of its largest magnitude; D splits its keys otherwise than the
    plain chunks and rounds P to bf16 against each split's own max, so
    its bf16 mode's bound; lse within 1e-5 of its largest magnitude),
    launched and counted, and its o cast bitwise the kernel's bf16
    output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, pages = _case(6, mx)
    rows = torch.tensor(ROWS, dtype=torch.int32, device="cuda")
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    fn = tops.paged_flash_decode_mx if mx else tops.paged_flash_decode
    before = fn.partial_launches
    o, lse = tops.ragged_paged_decode(q, rows, lengths, scale=SCALE,
                                      partial=True, **pages)
    assert fn.partial_launches == before + 1
    whole = tops.ragged_paged_decode(q, rows, lengths, scale=SCALE, **pages)
    assert torch.equal(o.to(torch.bfloat16), whole)
    if mx:
        qu = pages["quant"]
        po, pl = tref.paged_flash_decode_mx_ref(
            q, qu["kv_codes"], qu["k_exps"], qu["v_exps"], rows, lengths,
            scale=SCALE, bk=tops.pick_bk(W), partial=True)
    else:
        po, pl = tref.paged_flash_decode_ref(
            q, pages["kv"], rows, lengths, scale=SCALE, bk=tops.pick_bk(W),
            partial=True)
    tol = 1e-5 * float(po.abs().max()) if mx else 1e-2
    assert float((o - po).abs().max()) <= tol
    assert float((lse - pl).abs().max()) <= 1e-5 * float(pl.abs().max())
