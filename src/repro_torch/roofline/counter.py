"""The dry-run's counter: FLOPs, bytes and peak live bytes of a function
run on fake tensors (the port's counterpart of XLA's ``cost_analysis()``
and ``memory_analysis()``).

``trace(fn, args)`` runs ``fn`` under ``FakeTensorMode``, so no storage is
allocated at any width, with two dispatch modes above it:

- ``torch.utils.flop_counter.FlopCounterMode``: FLOPs, by its formulas
  (matrix products, convolutions, attention; elementwise ops count 0);
- ``ByteCounter``: bytes, the sum of every ATen op's input and output
  bytes, and the peak of the live bytes. This is the eager program's
  traffic with no credit for fusion: each op reads its inputs and writes
  its outputs once, as an eager kernel does. Ops whose outputs alias their
  inputs (views, ``detach``) move nothing and count nothing; an in-place
  op reads and writes its operand. Live bytes rise by a storage's bytes
  when an op makes it and fall when the storage dies, so what autograd
  saves for the backward stays counted until it is freed.

The args are made fake inside the mode from ``shape`` and ``dtype`` (meta
tensors, or anything with both); their storages are not counted as made
by the trace. The counts are per run of ``fn`` at the args' shapes.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class ByteCounter(TorchDispatchMode):
    """Bytes moved and live-byte peak of the ops dispatched under it.
    ``scale(t)`` gives the share of a new storage to count (1.0 by
    default): the dry-run counts a gradient at its layout's share of the
    param."""

    def __init__(self, scale=None):
        super().__init__()
        self.scale = scale
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, float] = {}     # storage -> bytes counted

    def _note(self, t: torch.Tensor, made: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        counted = 0.0
        if made:
            counted = st.nbytes() * (self.scale(t) if self.scale else 1.0)
            self.live += counted
            self.peak = max(self.peak, self.live)
        self._seen[key] = counted
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:                        # storages made before the trace
            self._note(t, made=False)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        in_keys = {_key(t) for t in ins}
        aliases = not func._schema.is_mutable and all(
            _key(t) in in_keys for t in outs)
        if not aliases:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._note(t, made=True)
        return out


@dataclasses.dataclass
class Counts:
    flops: int              # FlopCounterMode's total
    bytes: int              # every op's input + output bytes
    peak: float             # peak live bytes made by the run (args apart)
    out: object             # fn's result (fake tensors)


def trace(fn, args, *, scale=None, grad: bool = False) -> Counts:
    """Counts of ``fn(*args)`` on fake tensors. ``args`` is a tuple of
    trees whose leaves have ``shape`` and ``dtype`` (non-tensor leaves
    pass through); with ``grad`` every float arg requires grad."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(make(v) for v in tree)
        if not hasattr(tree, "shape") or not hasattr(tree, "dtype"):
            return tree
        t = torch.empty(tuple(tree.shape), dtype=tree.dtype)
        return t.requires_grad_() if grad and t.is_floating_point() else t

    with FakeTensorMode():
        fargs = make(tuple(args))
        flops = FlopCounterMode(display=False)
        counter = ByteCounter(scale)
        with flops, counter:
            out = fn(*fargs)
        return Counts(flops=int(flops.get_total_flops()),
                      bytes=int(counter.bytes), peak=counter.peak, out=out)
