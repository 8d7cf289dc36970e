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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import mx as mxlib
from repro_torch.distributed.collectives import LocalComm


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
