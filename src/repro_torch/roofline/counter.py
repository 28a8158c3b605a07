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

On DTensors the counts are one rank's: every mode here leaves a DTensor op
to DTensor, whose local ops (on the rank's shards) then come back through
the modes. ``RankFlops`` is ``FlopCounterMode``'s formulas over those
local ops (``FlopCounterMode`` itself counts a DTensor op at its global
shapes), and ``CollectiveLog`` records each collective the rank issues
(kind, result bytes, process group). ``trace_sharded`` runs a step so on
DTensor args made shard by shard under ``FakeTensorMode``, over a process
group that moves no data (``sharding/dtensor.init_fake_group``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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


@functools.cache
def _has_dtensor(types) -> bool:
    from repro_torch.sharding import dtensor as dtn
    return any(issubclass(t, dtn._dtensor()) for t in types)


#: depth of DTensor's shape probe running (see ``_probing``)
_PROBE = [0]


def _shape_probe() -> bool:
    """Whether the op being dispatched is DTensor's shape probe: on a cache
    miss its sharding propagation runs the op on fake tensors at global
    shapes to learn its output's shape. That computes nothing on any rank
    and is not counted (else a first run counts more than a later one)."""
    return _PROBE[0] > 0


@contextlib.contextmanager
def _probing():
    """Marks DTensor's shape probe (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``) while the block runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    probe = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                    None)
    if probe is None:            # a torch without the probe: nothing to mark
        yield
        return

    def marked(self, *a, **kw):
        _PROBE[0] += 1
        try:
            return probe(self, *a, **kw)
        finally:
            _PROBE[0] -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = probe


class _RankMode(TorchDispatchMode):
    """A dispatch mode that sees each rank's local ops (it leaves a
    DTensor op to DTensor) and not DTensor's shape probe."""

    def __enter__(self):
        self._probing = _probing()
        self._probing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._probing.__exit__(*exc)


class RankFlops(_RankMode):
    """FLOPs by ``FlopCounterMode``'s formulas (``flop_registry``) of the
    plain ops run under it: on DTensors, each rank's local ops. On plain
    tensors it counts what ``FlopCounterMode`` counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _shape_probe():
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


#: the functional collectives' op names and the roofline's kinds
KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


class CollectiveLog(_RankMode):
    """Every collective issued under it (``torch.distributed``'s functional
    collectives, which DTensor and the port issue), as
    ``(kind, result bytes, process group name, result shape, dtype)``."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, int, str, tuple, torch.dtype]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _shape_probe():
            return out
        kind = KINDS.get(func._opname) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            group = [a for a in args if isinstance(a, str)][-1]
            self.ops.append((kind, _nbytes(out), group, tuple(out.shape),
                             out.dtype))
        return out


class ByteCounter(_RankMode):
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
        if _has_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        if _shape_probe():
            return func(*args, **kwargs)
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
    collectives: list = dataclasses.field(default_factory=list)


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


def trace_sharded(fn, args, shardings) -> Counts:
    """One rank's counts of ``fn(*args)`` on DTensors: each arg leaf (with
    ``shape`` and ``dtype``) made as a DTensor of fake shards by its
    ``(mesh, placements)`` pair in ``shardings`` (the same structure), so
    nothing is allocated at any width. FLOPs are ``RankFlops``', the
    collectives ``CollectiveLog``'s. The default process group must be one
    of the mesh's size (a fake one: ``sharding/dtensor.init_fake_group``).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding import specs as sh

    def empty(shape, dtype, device):
        return torch.empty(shape, dtype=dtype, device=device)

    with FakeTensorMode():
        fargs = tuple(sh.make_leaves(a, s, empty)
                      for a, s in zip(args, shardings))
        flops, counter, log = RankFlops(), ByteCounter(), CollectiveLog()
        with flops, counter, log:
            out = fn(*fargs)
        return Counts(flops=flops.flops, bytes=int(counter.bytes),
                      peak=counter.peak, out=out, collectives=log.ops)
