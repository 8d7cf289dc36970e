"""A meta-device cost counter: what a step would cost on the card, counted
without running it.

:class:`CostCounter` is a ``TorchDispatchMode``. A step run under it on
``meta`` tensors (shapes and dtypes, no storage) goes through the same
Python code, the same torch ops and the same kernel wrappers as on the
card, and the counter records four things:

- ``flops``: the operations of every aten op that
  ``torch.utils.flop_counter`` has a formula for (``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` -- ``matmul`` and ``einsum`` lower to these --,
  convolutions and SDPA), plus each hand-written kernel's own count.
- ``bytes``: the bytes every op reads and writes: each tensor input's
  distinct elements (an expanded dim, of stride 0, is read once) and each
  output, at their element sizes; views, reshapes and ``empty`` move
  nothing. This is the port's unfused eager count, in the role of XLA's
  "bytes accessed": a fused program would move less.
- ``peak``: the most bytes that the ops' outputs held at once, by
  storage (a view or an in-place op adds nothing), each storage rounded
  up to the CUDA caching allocator's 512-byte blocks. Tensors made
  before the counter was entered (a step's arguments) are not in it.
- ``kernel_calls``: each kernel wrapper's calls by route
  (``{"mxfp4_matmul": {"mma": 97}}``), recorded by the wrapper's ``meta``
  branch through :func:`record_kernel` with its ``cost()`` model.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

ALLOC_BLOCK = 512  # the CUDA caching allocator's rounding of a block
_aten = torch.ops.aten
# ops that make or re-describe a tensor without reading or writing data
_NO_TRAFFIC = {_aten._unsafe_view, _aten.empty, _aten.empty_strided,
               _aten.empty_like, _aten.new_empty, _aten.new_empty_strided,
               _aten.detach, _aten.lift_fresh, _aten.alias, _aten.as_strided,
               _aten._reshape_alias, _aten.resize_, _aten.set_}
_ACTIVE: list = []


def active():
    """The innermost entered :class:`CostCounter`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, route: str, ops: float, n_bytes: float) -> None:
    """A kernel wrapper's ``meta`` branch: one call of kernel ``name`` on
    ``route`` with its cost model's operations and bytes."""
    c = active()
    if c is not None:
        c.add_kernel(name, route, ops, n_bytes)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses: the product of its
    sizes over the dims with a nonzero stride."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def tensors(x):
    """The tensors of a nest of lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, peak live bytes and kernel calls of the ops run
    inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.kernel_calls: dict = {}
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self._storages: dict = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, route: str, ops: float,
                   n_bytes: float) -> None:
        routes = self.kernel_calls.setdefault(name, {})
        routes[route] = routes.get(route, 0) + 1
        self.kernel_flops += ops
        self.kernel_bytes += n_bytes
        self.flops += ops
        self.bytes += n_bytes

    def _free(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self._storages[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += sum(tensor_bytes(t) for t in tensors(args))
            self.bytes += sum(tensor_bytes(t) for t in tensors(kwargs))
            self.bytes += sum(tensor_bytes(t) for t in tensors(out))
        ins = {t.untyped_storage()._cdata
               for t in tensors((args, kwargs))}
        for t in tensors(out):
            if t.untyped_storage()._cdata not in ins:  # not a view, in place
                self._track(t)
        return out
