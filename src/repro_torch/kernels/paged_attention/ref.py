"""Plain PyTorch versions of ragged paged decode over the fused layout.

- :func:`ragged_paged_decode_ref` is the dense whole-key-axis function
  the JAX package runs off the TPU (``repro.kernels.paged_attention.ref``):
  it gathers the lanes' pages and runs the legacy decode math with P
  quantized along the whole key axis.
- :func:`paged_flash_decode_ref` is the plain version of the float-page
  CUDA kernel, a port of the Pallas ``_decode_kernel`` with
  ``_online_update(mx=False)``: the chunked online softmax at ``bk``, the
  tail chunk fetched at the clamped offset ``min(c*bk, W-bk)`` with the
  overlap masked, an f32 running max and sum, and PV over P cast to the
  page dtype, accumulated in f32. The Pallas source asks for a bf16 PV
  (``einsum(...).astype(f32)``), but XLA compiles the kernel's dot with an
  f32 result and folds the bf16 round trip away, so the reference, as it
  runs, adds the unrounded PV; this version does the same and matches
  its interpret run bitwise on the tested pages.
- :func:`paged_flash_decode_mx_ref` is the plain version of the mx
  CUDA kernel, a port of the Pallas ``_decode_kernel_mx``: the
  chunked online softmax at the same ``bk``, tail chunk fetched at the
  clamped offset ``min(c*bk, W-bk)`` with the overlap masked, P
  fake-quantized per chunk in 32-key blocks aligned to that offset, bf16
  PV with f32 accumulation and a running normaliser of the quantized P.

Lane ``i`` attends over slots ``[0, lengths[i])`` of pool row ``rows[i]``;
a lane of length 0 yields zeros. With ``partial=True`` the two chunked
versions return the flash-decoding partial of those slots instead: ``o =
acc / l`` in f32 (its bf16 cast is the plain output, bitwise) and ``lse
= m + log l`` in f32 [L, Hkv, G], ``-inf`` for a lane with no live slot
(its o is 0); ``distributed.seq_parallel.combine_partials`` joins the
partials of a page's blocks. "bf16 operands with f32 accumulation"
is computed as an f32 product of the (exactly bf16-valued) operands.
"""

from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib
from repro_torch.kernels.paged_attention import layout

BLOCK = mxlib.BLOCK
NEG_INF = -1e30


def ragged_paged_decode_ref(q, rows, lengths, *, kv=None, quant=None,
                            scale: float) -> torch.Tensor:
    """q [L, Hkv, G, Dh] (mx path: already MXFP4-fake-quant bf16) ->
    [L, Hkv, G, Dh]; bf16 on the mx path, ``kv.dtype`` on the float path."""
    hd = q.shape[-1]
    mx = quant is not None
    rows = rows.long()
    if mx:
        kvc = quant["kv_codes"][rows]
        kd = layout.dequant_k_pages(kvc, quant["k_exps"][rows], hd)
        vd = layout.dequant_v_pages(kvc, quant["v_exps"][rows], hd)
        w = kvc.shape[1]
    else:
        kd, vd = layout.split_kv(kv[rows])
        w = kv.shape[1]
    valid = (torch.arange(w, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])  # [L, W]
    sc = torch.einsum("bhgd,bkhd->bhgk", q.float(), kd.float()) * scale
    if mx:
        sc = sc.to(torch.bfloat16).float()  # systolic round
    sc = torch.where(valid[:, None, None, :], sc, float("-inf"))
    pr = torch.softmax(sc, dim=-1)
    pr = torch.where(valid.any(-1)[:, None, None, None], pr, 0.0)
    if mx:
        pr = mxlib.fake_quant(pr)  # P quantized along the key axis
        den = pr.sum(-1, keepdim=True)
        den = torch.where(den == 0.0, 1.0, den)
        o = torch.einsum("bhgk,bkhd->bhgd", pr.to(torch.bfloat16).float(),
                         vd.float())
        return (o / den).to(torch.bfloat16)
    o = torch.einsum("bhgk,bkhd->bhgd", pr.to(vd.dtype).float(), vd.float())
    return o.to(vd.dtype)


def paged_flash_decode_ref(q, kv, rows, lengths, *, scale: float,
                           bk: int, partial: bool = False):
    """Chunked online-softmax decode over float pages kv [P, W, 2Hkv, Dh],
    all lanes and KV heads at once -> ``kv.dtype`` [L, Hkv, G, Dh]
    (``partial``: the (o, lse) of the module's docstring). As in
    :func:`paged_flash_decode_mx_ref`, a chunk past a lane's length leaves
    its state bitwise unchanged."""
    L, hkv, g, hd = q.shape
    w = kv.shape[1]
    rows = rows.long()
    lengths = lengths.to(q.device).long()
    qf = q.float()
    acc = torch.zeros((L, hkv, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((L, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((L, hkv, g), dtype=torch.float32, device=q.device)
    nchunks = -(-int(lengths.max()) // bk) if L else 0
    for c in range(nchunks):
        offs = min(c * bk, w - bk)
        k, v = layout.split_kv(kv[rows, offs:offs + bk])  # [L, bk, Hkv, Dh]
        pos = offs + torch.arange(bk, device=q.device)
        live = (pos[None, :] >= c * bk) & (pos[None, :] < lengths[:, None])
        live = live[:, None, None, :]  # [L, 1, 1, bk]
        s = torch.einsum("lhgd,lkhd->lhgk", qf, k.float()) * scale
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(live, p, 0.0)
        corr = torch.exp(m - m_new)
        pv = torch.einsum("lhgk,lkhd->lhgd", p.to(kv.dtype).float(),
                          v.float())
        acc = acc * corr[..., None] + pv
        l = l * corr + p.sum(-1)
        m = m_new
    return _finish(acc, m, l, kv.dtype, partial)


def paged_flash_decode_mx_ref(q, kv_codes, k_exps, v_exps, rows, lengths, *,
                              scale: float, bk: int, partial: bool = False):
    """Chunked online-softmax decode from the quantized mirrors, all lanes
    and KV heads at once -> bf16 [L, Hkv, G, Dh] (``partial``: (o, lse)).
    A chunk past a lane's length is all-dead for it
    and leaves its state bitwise unchanged (corr = 1, P = 0), so running
    every lane to the longest lane's chunk count is the per-lane loop."""
    L, hkv, g, hd = q.shape
    w = kv_codes.shape[1]
    rows = rows.long()
    lengths = lengths.to(q.device).long()
    qf = q.float()
    acc = torch.zeros((L, hkv, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((L, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((L, hkv, g), dtype=torch.float32, device=q.device)
    nchunks = -(-int(lengths.max()) // bk) if L else 0
    for c in range(nchunks):
        offs = min(c * bk, w - bk)
        sl = slice(offs, offs + bk)
        kvc = kv_codes[rows, sl]  # [L, bk, 2Hkv, Dpad//2]
        k = layout.dequant_k_pages(kvc, k_exps[rows, sl], hd)
        pos = offs + torch.arange(bk, device=q.device)
        # V: slot-block shared exponents of the fetched slots (globally
        # 32-aligned, so offs need not be)
        vcodes = mxlib.unpack_pairs_bf16(kvc[..., 1::2, :])[..., :hd]
        vexp = v_exps[rows[:, None], (pos // BLOCK)[None, :]]  # [L, bk, Hkv, Dh]
        vd = vcodes * mxlib.exp2i(vexp.to(torch.int32) - 1).to(torch.bfloat16)
        live = (pos[None, :] >= c * bk) & (pos[None, :] < lengths[:, None])
        live = live[:, None, None, :]  # [L, 1, 1, bk]
        s = torch.einsum("lhgd,lkhd->lhgk", qf, k.float()) * scale
        s = s.to(torch.bfloat16).float()
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(live, p, 0.0)
        corr = torch.exp(m - m_new)
        p = mxlib.fake_quant(p)  # per chunk, 32-key blocks from offs
        pv = torch.einsum("lhgk,lkhd->lhgd", p.to(torch.bfloat16).float(),
                          vd.float())
        acc = acc * corr[..., None] + pv
        l = l * corr + p.sum(-1)
        m = m_new
    return _finish(acc, m, l, torch.bfloat16, partial)


def _finish(acc, m, l, dtype, partial: bool):
    """The output ``acc / l`` (l == 0 -> 1) in ``dtype``, or with
    ``partial`` that quotient in f32 and the lanes' ``m + log l``."""
    den = torch.where(l == 0.0, 1.0, l)
    o = acc / den[..., None]
    if not partial:
        return o.to(dtype)
    return o, torch.where(l == 0.0, float("-inf"), m + torch.log(den))

