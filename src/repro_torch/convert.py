"""Carry the reference's parameters into the port.

:func:`from_reference` takes the JAX package's parameter tree as nested
dicts and lists of **numpy arrays** (float, or CIM-converted: ``codes``
int8, ``exps`` int8, ``e_n`` int32, ``adc_fs`` f32, ``b``), for example
``jax.tree.map(np.asarray, params)``, and returns the port's tree: the
same keys (the Zamba shared block's top-level ``shared`` among them),
tensors on ``device``, and each stacked segment (leading layer axis,
``repro.models.lm._stack``) unstacked into one dict per layer; a
single-layer segment stays one dict. An
MoE layer's expert banks unstack with it: a float bank [n, E, K, N]
becomes [E, K, N] a layer, a packed one (``codes`` [n, E, K//2, N],
``exps`` [n, E, K//32, N]) becomes [E, K//2, N] / [E, K//32, N], each
expert's slice the ``mxfp4_matmul`` kernel's resident format.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import mx as mxlib


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map(v, fn) for v in node]
    return fn(node)


def _n_stacked(seg: dict) -> int:
    """Layers in a reference segment, from the segment's own norm gamma,
    [n, d] when stacked and [d] for a single layer: the attention norm of
    ``attn`` and ``moe_attn`` segments, the block norm ``ln`` of
    ``mamba`` / ``mlstm`` / ``slstm`` ones. A ``zshared`` segment is
    ``{}`` (its weights are the top-level ``shared``): one visit."""
    ln = seg["attn"]["ln"] if "attn" in seg else seg.get("ln")
    if ln is None:
        return 0
    gamma = ln["gamma"]
    return gamma.shape[0] if gamma.ndim == 2 else 0


def from_reference(tree, device=None) -> dict:
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev))
           for k, v in tree.items() if k != "segments"}
    segs = []
    for seg in tree["segments"]:
        n = _n_stacked(seg)
        if n == 0:
            segs.append([_map(seg, lambda a: _tensor(a, dev))])
        else:
            segs.append([_map(seg, lambda a, j=j: _tensor(np.asarray(a)[j], dev))
                         for j in range(n)])
    out["segments"] = segs
    return _map_dicts(out, _kmajor_cim)


def _kmajor_cim(node: dict) -> dict:
    """CIM-converted nodes keep their codes and exps K-major, the layout
    the port's kernel reads (``core.mx.MXW``)."""
    if "e_n" in node:
        node = dict(node, codes=mxlib.kmajor(node["codes"]),
                    exps=mxlib.kmajor(node["exps"]))
    return node


def _map_dicts(node, fn):
    if isinstance(node, dict):
        return fn({k: _map_dicts(v, fn) for k, v in node.items()})
    if isinstance(node, list):
        return [_map_dicts(v, fn) for v in node]
    return node
