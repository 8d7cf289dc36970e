"""Tensor parallelism over the mesh's ``model`` axis: the autograd
functions that the layers run over the model axis's collectives
(``collectives.AxisComm``, ``RunCtx.tp``), the port's counterpart of the
collectives XLA's GSPMD partitioner inserts into the reference's train
step where the rules put ``heads``, ``qkv_fused``, ``kv_fused``, ``mlp``
and ``vocab`` on ``model``.

- :func:`copy_to_model`: the identity, whose gradient is summed over the
  model ranks: the replicated input of a column-parallel product
  (``wq`` / ``wk`` / ``wv``, ``w1`` / ``w3``, the head).
- :func:`reduce_from_model`: the sum of the ranks' partial values, whose
  gradient passes to each rank's part as it is: the output of a
  row-parallel product (``wo``, ``w2``), a vocab-parallel lookup, the
  vocab-parallel loss's sums. ``torch.distributed.nn.functional.
  all_reduce`` is not this: its backward all-reduces gradients that are
  already the same on every model rank, which multiplies them by the
  model size.
- :func:`gather_from_model`: a feature all-gather for a consumer every
  rank runs alike, whose gradient is the rank's slice: the vision front
  end's columns; the keys and values whose fused dim is cut inside a KV
  head, whose heads' gradients ``copy_to_model`` sums first, in f32, at
  the attention's input (a reduce-scatter after the rank's heads' bf16
  sums would round each rank's part first).
- :func:`fake_quant_cut`: MXFP4 fake-quant (STE) along a dim cut over
  ``model``: on the rank's part where its length is a whole number of
  32-blocks, else gathered, quantized whole and cut again; bitwise that
  part of the whole tensor's quant either way.
- :func:`matmul_f32`: a bf16 product with f32 output (exact products,
  f32 sums), whose gradients are the bf16 products autograd takes for a
  bf16 ``matmul``: a row-parallel partial product before its reduction,
  so the sum over the ranks rounds once, as the one-device product does.
- :func:`matmul_bf16`: the bf16 product of a column-parallel linear
  (bf16 out, as the one-device product), whose input gradient is taken
  in f32 and left unrounded: each rank's is its columns' part of a sum
  over the model ranks, which then rounds once.

Sums over the model ranks run in f32 and are cast back once.
"""

from __future__ import annotations

import torch

from repro_torch.core import mx as mxlib


def _sum_f32(comm, x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of ``x``, taken in f32 and cast back
    to ``x``'s dtype once (a new tensor)."""
    y = x.to(torch.float32, copy=True)
    comm.all_reduce(y)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(ctx.comm, g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return _sum_f32(comm, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.block(g, ctx.dim).contiguous(), None, None


class _FakeQuantCut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        whole = mxlib.fake_quant_axis(comm.all_gather(x, dim), dim)
        return comm.block(whole, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a`` [..., K] @ bf16 ``b`` [K, N] with f32 products and sums,
    f32 out."""
    if a.is_cuda:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class _MatmulF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = torch.matmul(g, b.T)
        db = torch.matmul(a.reshape(-1, a.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
        return da, db


class _MatmulBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a = a.to(torch.bfloat16)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = _mm_f32(g, b.T)
        db = torch.matmul(a.reshape(-1, a.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
        return da, db


def copy_to_model(x: torch.Tensor, comm) -> torch.Tensor:
    """``x`` (replicated over ``model``) into a column-parallel product:
    the identity, whose gradient is summed over the model ranks (in f32;
    each rank's is its columns' part)."""
    return _CopyToModel.apply(x, comm)


def reduce_from_model(x: torch.Tensor, comm) -> torch.Tensor:
    """The sum over the model ranks of their partial ``x`` (in f32, cast
    back once), replicated; the gradient passes to each rank's part as it
    is."""
    return _ReduceFromModel.apply(x, comm)


def gather_from_model(x: torch.Tensor, comm, dim: int = -1) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim``, for a consumer
    that every rank runs alike: the gradient is the rank's slice."""
    return _GatherFromModel.apply(x, comm, dim % x.ndim)


def fake_quant_cut(x: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """``mx.fake_quant_axis(x, dim)`` of the whole tensor, of which ``x``
    is this model rank's block along ``dim`` (``comm`` None: ``x`` is
    whole): on the block where its length is a multiple of the 32-block,
    else gathered over the model ranks, quantized and cut (exact either
    way). The gradient is the STE's identity."""
    dim = dim % x.ndim
    if comm is None or x.shape[dim] % mxlib.BLOCK == 0:
        return mxlib.fake_quant_axis(x, dim)
    return _FakeQuantCut.apply(x, comm, dim)


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.to(bf16) @ b`` for f32 ``a`` [..., K] of bf16 values and bf16
    ``b`` [K, N], bf16 out (the one-device product); the gradient of
    ``a`` in f32 (f32 products and sums), that of ``b`` in bf16."""
    return _MatmulBF16.apply(a, b)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 ``a`` [..., K] and ``b`` [K, N] in f32: each
    product exact, the sums in f32, not rounded to bf16 (on CUDA cuBLAS's
    bf16 product with an f32 output). Its gradients are bf16, as a bf16
    ``torch.matmul``'s."""
    return _MatmulF32.apply(a, b)
