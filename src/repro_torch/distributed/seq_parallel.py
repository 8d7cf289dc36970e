"""The decode over a KV cache whose sequence axis is cut over ranks: the
port's counterpart of the flash-decoding that XLA's GSPMD partitioner
writes into the reference's decode step, where the rules put the resident
cache's ``cache_seq`` axis on ``model`` (or on ``(data, model)`` when the
batch cannot fill the data axes) and keep ``heads`` whole
(``distributed.sharding.make_rules``: "XLA inserts the partial-softmax
combines").

A :class:`SeqShard` names the rank's block of a layer's cache sequence
(``index`` of ``n``) and the collectives over the ranks that hold the
other blocks (``comm``: the axes the resolved ``cache_seq`` spec names).
Each segment's layers share one (their caches have one shape).

:func:`legacy_decode` is the legacy decode of ``layers.attention`` on
the rank's block (on one device, :data:`WHOLE`: one block, every
collective the identity):

- the lane's new K/V row (and under the digital SDPA its K codes and the
  32-block of V it falls in, requantized) is written by the rank whose
  block holds slot ``pos % W`` only, ``W`` the layer's whole window;
- each rank scores its slots, the validity mask in global slot indices;
- the softmax's max and sum are combined over ``comm`` (an all-reduce of
  the max, then one of the sums) and P is normalised by them before it
  is rounded, as on one device;
- float: P rounded to the cache's dtype, the f32 PV partials summed over
  ``comm`` (one all-reduce);
- digital SDPA: P quantized per 32-block on the rank's slots (whole
  blocks, or it raises), the quantized P's sums and the PV partials
  summed in f32 in one all-reduce before the division.

The result differs from one device's only in the order of the f32 sums
(the PV partials' and the softmax sum's).
The quantized V mirror's exponents (``v_exps``, replicated in the
reference's specs, ``layers.attention.ATTN_QUANT_CACHE_SPECS``) are held
as each rank's blocks, beside its ``v_codes``: the rank that writes a
slot requantizes its V block and has the block's exponent, and no other
rank reads it.

:func:`fused_decode` is the fused paged decode of ``layers.attention``
on the rank's block of a fused pool (its ``kv`` and, under the digital
SDPA, its ``kv_codes``, ``k_exps`` and ``v_exps``, held as each rank's
32-slot blocks as the legacy ``v_exps`` are):

- the lane's row is written, and its mirrors requantized, by the rank
  whose block holds slot ``pos % W`` only;
- each rank's lanes attend over a contiguous prefix of its block,
  ``clamp(min(pos + 1, W) - lo, 0, w_local)`` slots;
- kernel D (float pages) or B (the mirrors) runs in its partial mode on
  the block (``kernels.paged_attention.ops``, ``partial=True``), at the
  block's own chunk width, and returns (o, lse);
- one all-gather of the packed [o | lse] over ``comm``, and every rank
  combines the partials in rank order (:func:`combine_partials`): the
  same bits on every rank, one sync point for the attention.

Under the digital SDPA B quantizes P per chunk against its running max,
so a block's partial is not a piece of the whole page's sum: the ranks
compute the decode of the page over its blocks, combined (bitwise the
same function run block by block on one device), which agrees with the
dense function (``ragged_paged_decode_ref``) as closely as the whole
page's kernel does. On one device (:data:`WHOLE`) it is the one-kernel
decode of the whole page, or with ``partial`` the partial mode at one
block, whose combine is the identity (w = 1), bitwise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import mx as mxlib
from repro_torch.distributed.collectives import LocalComm
from repro_torch.kernels.paged_attention import layout as paged_layout
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's block ``index`` of ``n`` of a cache's sequence axis and
    the collectives over the ranks that hold the blocks
    (``collectives.AxisComm``)."""

    comm: object
    n: int
    index: int

    def bounds(self, w_local: int) -> tuple[int, int]:
        """(first global slot of the block, the whole window)."""
        return self.index * w_local, w_local * self.n


WHOLE = SeqShard(LocalComm(), 1, 0)  # one device: the whole sequence


def check_blocks(w_local: int, what: str) -> None:
    """A slice of a cache's key axis that the digital SDPA quantizes in
    32-blocks must be whole blocks."""
    if w_local % mxlib.BLOCK:
        raise NotImplementedError(
            f"{what}: a cache-sequence block of {w_local} slots is not a "
            f"whole number of {mxlib.BLOCK}-blocks; see ROADMAP.md")


def keep_block(t: torch.Tensor, dim: int, shard: SeqShard) -> torch.Tensor:
    """This rank's block of ``t`` (the whole window) along ``dim``."""
    n = t.shape[dim] // shard.n
    return t.narrow(dim, shard.index * n, n).contiguous()


def _owner_write(dst: torch.Tensor, lanes, slot, new, mine) -> None:
    """``dst[lanes, slot] = new`` where ``mine`` (every lane: None), else
    unchanged (no host sync, no data-dependent shape)."""
    if mine is None:
        dst[lanes, slot] = new.to(dst.dtype)
        return
    keep = dst[lanes, slot]
    m = mine.reshape((-1,) + (1,) * (keep.ndim - 1))
    dst[lanes, slot] = torch.where(m, new.to(dst.dtype), keep)


def write_row(cache: dict, k, v, pos_b, shard: SeqShard) -> tuple:
    """Write each lane's new K/V row at global slot ``pos % W`` where this
    rank holds it, and (under the resident mirrors) requantize that K row
    and the V 32-block holding it on the rank's block. Returns (lanes,
    local slot, mine)."""
    from repro_torch.layers.attention import _quant_cache_step

    ck, cv = cache["k"], cache["v"]
    b, wl = ck.shape[0], ck.shape[1]
    lo, w = shard.bounds(wl)
    slot = pos_b % w
    lanes = torch.arange(b, device=ck.device)
    mine, ls = None, slot  # one block: every lane writes
    if shard.n > 1:
        mine = (slot >= lo) & (slot < lo + wl)
        ls = torch.clamp(slot - lo, 0, wl - 1)
    _owner_write(ck, lanes, ls, k[:, 0], mine)
    _owner_write(cv, lanes, ls, v[:, 0], mine)
    if "k_codes" in cache:
        if shard.n > 1:
            check_blocks(wl, "the resident mirrors")
        _quant_cache_step(cache, ck, cv, lanes, ls, write=mine)
    return lanes, ls, mine


def legacy_decode(cfg, q, k, v, cache: dict, pos, mx_dig: bool,
                  shard: SeqShard = None) -> torch.Tensor:
    """One decode step over the legacy split cache, the reference's einsum
    decode, on this rank's block of it (``shard``; default :data:`WHOLE`:
    one device): each lane's new K/V row written in place at slot
    ``pos % W`` (``pos`` an int or an int tensor, 0-d or [B]) by its
    owner, its query attending over slots ``<= pos`` (all W once the ring
    has wrapped). The softmax's max and sum are combined over
    ``shard.comm`` and P normalised by them before any rounding, as the
    one-device softmax is; the PV partials are then summed over the ranks
    in f32 (one block: ``torch.softmax`` and the PV product rounded once,
    a kernel each, the one-device decode's cost).
    Under the digital SDPA, Q and K are quantized along head_dim (K read
    back from the resident mirrors, updated in place, or requantized whole
    each step), the scores get the BF16 round, P is quantized along the
    key axis and V along its key axis (resident or requantized), and the
    output is divided by the quantized P's sum (summed over the ranks
    with the PV partials). q [B, 1, Hkv, G, Dh] (every head), k / v
    [B, 1, Hkv, Dh]; returns [B, 1, Hkv, G, Dh] in the cache's dtype on
    every rank."""
    from repro_torch.layers import attention as A

    shard = shard or WHOLE
    b, hd = q.shape[0], cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    wl = ck.shape[1]
    lo, w = shard.bounds(wl)
    dev = q.device
    pos_b = torch.as_tensor(pos, device=dev).to(torch.long).expand(b)
    write_row(cache, k, v, pos_b, shard)
    resident = "k_codes" in cache
    gidx = lo + torch.arange(wl, device=dev)
    valid = (gidx[None, :] <= pos_b[:, None]) | (pos_b[:, None] >= w)
    qd, kd = q, ck
    if mx_dig:
        if shard.n > 1:
            check_blocks(wl, "the digital SDPA's P quantization")
        qd = A._mx_fq(q)
        if resident:  # O(1) a step: K read back from its codes
            kd = mxlib.dequantize(mxlib.MX(cache["k_codes"],
                                           cache["k_exps"]), out_len=hd)
        else:  # the requant-per-step reference
            kd = A._mx_fq(ck)
        qd, kd = qd.to(torch.bfloat16), kd.to(torch.bfloat16)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qd.float(), kd.float()) * cfg.scale
    if mx_dig:
        sc = A._mx_score_round(sc)
    sc = torch.where(valid[:, None, None, None, :], sc, float("-inf"))
    if shard.n == 1:  # one block: the softmax and the PV in one kernel each
        p = torch.softmax(sc, dim=-1)
    else:
        # slot 0 is valid in every lane, so the max over the ranks is finite
        mx = sc.amax(-1, keepdim=True)
        shard.comm.all_reduce(mx, op=dist.ReduceOp.MAX)
        p = torch.exp(sc - mx)  # 0 at the masked slots
        ssum = p.sum(-1, keepdim=True)  # [B, Hkv, G, 1, 1]
        shard.comm.all_reduce(ssum)
        p = p / ssum  # the softmax
    if not mx_dig:
        if shard.n == 1:  # bf16 operands, f32 accumulation, one rounding
            return torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype), cv)
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype).float(),
                          cv.float())
        return shard.comm.all_reduce(pv).to(cv.dtype)
    pr = mxlib.fake_quant(p)
    if resident:
        vd = torch.movedim(mxlib.dequantize(
            mxlib.MX(cache["v_codes"], cache["v_exps"]), out_len=wl), -1, 1)
    else:
        vd = mxlib.fake_quant_axis(cv, 1)  # bf16-native chain
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(torch.bfloat16).float(),
                     vd.to(torch.bfloat16).float())
    den, o = _sum_pair(shard.comm, pr.sum(-1, keepdim=True), o)
    den = torch.where(den == 0.0, 1.0, den)
    return (o / torch.movedim(den, -2, 1)).to(cv.dtype)


def fused_decode(ctx, cfg, q, k, v, cache: dict, pos, mx_dig: bool,
                 shard: SeqShard = None, partial: bool = False
                 ) -> torch.Tensor:
    """One fused paged decode step on this rank's block of the pool
    (``shard``; default :data:`WHOLE`: the whole page, one kernel launch
    as the engine's step) at the pool rows ``ctx.paged_rows`` (default:
    lane i -> row i): each lane's K/V row and its mirrors written in
    place at slot ``pos % W`` by its owner, then the decode over the
    lane's valid slots, kernel B or D in the partial mode over a cut
    sequence (or with ``partial``: at one block, identity collectives)
    and the blocks' partials combined (see the module). q [B, 1, Hkv, G,
    Dh]; k / v [B, 1, Hkv, Dh]; returns [B, 1, Hkv, G, Dh], bf16, on every
    rank."""
    from repro_torch.layers import attention as A

    shard = shard or WHOLE
    partial = partial or shard.n > 1
    b = q.shape[0]
    kvp = cache["kv"]
    wl = kvp.shape[1]
    lo, w = shard.bounds(wl)
    dev = q.device
    pos_b = torch.as_tensor(pos, device=dev).to(torch.long).expand(b)
    rows = (torch.arange(b, device=dev) if ctx.paged_rows is None
            else ctx.paged_rows.to(device=dev, dtype=torch.long))
    slot = pos_b % w
    resident = "kv_codes" in cache
    mine, ls = None, slot  # one block: every lane writes
    if shard.n > 1:
        if resident:
            check_blocks(wl, "the fused pool's resident mirrors")
        mine = (slot >= lo) & (slot < lo + wl)
        ls = torch.clamp(slot - lo, 0, wl - 1)
    _owner_write(kvp, rows, ls, paged_layout.fuse_kv(k[:, 0], v[:, 0]), mine)
    if resident:
        paged_layout.quant_page_step(cache, kvp, rows, ls, write=mine)
    # min(pos+1, W): a contiguous valid prefix, all W once the ring wraps;
    # the block's part of it
    lengths = torch.clamp(torch.clamp(pos_b + 1, max=w) - lo, 0, wl).to(
        torch.int32)
    qd, kv_pages, quant = q, kvp, None
    if mx_dig:
        if not resident:
            raise ValueError("fused paged decode under a digital-SDPA backend "
                             "needs the quantized-resident mirrors — init the "
                             "cache with mx_digital=True")
        qd = A._mx_fq(q).to(torch.bfloat16)
        kv_pages = None
        quant = {n: cache[n] for n in ("kv_codes", "k_exps", "v_exps")}
    if ctx.impl == "ref":
        if partial:
            raise ValueError("impl='ref' runs the dense whole-page decode, "
                             "which has no partial form over a cut cache "
                             "sequence")
        o = paged_ref.ragged_paged_decode_ref(
            qd[:, 0], rows, lengths, kv=kv_pages, quant=quant,
            scale=cfg.scale)
        return o[:, None]
    out = paged_ops.ragged_paged_decode(
        qd[:, 0], rows, lengths, kv=kv_pages, quant=quant, scale=cfg.scale,
        obs=ctx.obs, partial=partial)
    if not partial:
        return out[:, None]
    o, lse = gather_partials(shard.comm, *out)
    return combine_partials(o, lse, torch.bfloat16 if mx_dig
                            else kvp.dtype)[:, None]


def gather_partials(comm, o: torch.Tensor, lse: torch.Tensor) -> tuple:
    """The ranks' partials (o [L, Hkv, G, Dh], lse [L, Hkv, G], f32) in rank
    order, in one all-gather of the packed [o | lse] over ``comm``:
    (o [n, L, Hkv, G, Dh], lse [n, L, Hkv, G])."""
    packed = torch.cat([o, lse[..., None]], dim=-1).unsqueeze(0)
    full = comm.all_gather(packed, 0)
    return full[..., :-1], full[..., -1]


def combine_partials(o: torch.Tensor, lse: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """The decode over a page from the partials of its blocks, in block
    order (flash-decoding): o [n, ..., Dh] and lse [n, ...] f32 ->
    ``sum_r w_r o_r / sum_r w_r`` with ``w_r = exp(lse_r - max_r
    lse_r)``, cast to ``dtype`` once; 0 where every block is empty (lse
    ``-inf``, o 0). One block gives its o cast, bitwise (w = 1)."""
    top = lse.amax(0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    num = den = None
    for r in range(o.shape[0]):
        wr = torch.exp(lse[r] - top)  # 0 for an empty block
        part = wr[..., None] * o[r]
        num = part if num is None else num + part
        den = wr if den is None else den + wr
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).to(dtype)


def _sum_pair(comm, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``a`` and ``b`` (f32) summed over ``comm`` in one all-reduce."""
    flat = torch.cat([a.reshape(-1), b.reshape(-1)])
    comm.all_reduce(flat)
    return (flat[:a.numel()].reshape(a.shape),
            flat[a.numel():].reshape(b.shape))


def gather_heads(comm, *parts: torch.Tensor) -> list:
    """Column-parallel outputs (the rank's features of each of ``parts``,
    [..., n_i]) gathered over the model ranks in one all-gather: each
    part's whole features, in rank order."""
    widths = [p.shape[-1] for p in parts]
    local = torch.cat(parts, dim=-1)
    full = comm.all_gather(local.unsqueeze(0), 0)  # [m, ..., sum n_i]
    out, off = [], 0
    for n in widths:
        blk = full[..., off:off + n]  # [m, ..., n]
        out.append(torch.movedim(blk, 0, -2).reshape(
            blk.shape[1:-1] + (comm.size * n,)))
        off += n
    return out
