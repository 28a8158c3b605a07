"""Compute on ``torch.distributed.tensor.DTensor``s: the port's counterpart
of GSPMD partitioning the reference's jitted steps.

The model code runs on plain tensors and on DTensors alike. On DTensors,
DTensor's own propagation partitions most ops; the helpers here are the
few places where the port says where data moves, as the reference's
``with_sharding_constraint`` calls do, or runs a function on each rank's
shards:

- ``whole_on(x, "model")``: ``x`` replicated on the model axis (a
  sequence-sharded stream is all-gathered, partial sums all-reduced): the
  input of a column-parallel product;
- ``settle(x, placements)``: ``x`` redistributed to ``placements`` (a
  row-parallel product's partial sums reduced, or reduce-scattered into a
  sequence-sharded stream);
- ``on_shards(fn, out_placements, *args)``: ``fn`` on each rank's local
  shards (``local_map``), the outputs wrapped with ``out_placements``;
- ``group_sum(parts)``: scalars that hold partial sums over different
  mesh dims, reduced with one all-reduce per pattern;
- ``init_fake_group(world)``: a process group of ``world`` ranks that moves
  no data (``FakeProcessGroup``), so one process can run, or trace, one
  rank of a production mesh.

Every helper returns a plain tensor unchanged, so the one-device path keeps
its arithmetic.
"""

from __future__ import annotations

import functools


@functools.cache
def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dt(x) -> bool:
    return isinstance(x, _dtensor())


def any_dt(*trees) -> bool:
    """Whether some leaf of ``trees`` (dicts, lists, tuples) is a DTensor."""
    def walk(t):
        if isinstance(t, dict):
            return any(walk(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return any(walk(v) for v in t)
        return is_dt(t)
    return walk(trees)


def mesh_dim(mesh, name: str) -> int | None:
    """Index of the mesh dim called ``name`` (None if there is none)."""
    names = tuple(mesh.mesh_dim_names or ())
    return names.index(name) if name in names else None


def local_rank(mesh, name: str) -> int:
    """This rank's coordinate on the mesh dim ``name`` (0 without it)."""
    d = mesh_dim(mesh, name)
    return 0 if d is None else mesh.get_local_rank(d)


def settle(x, placements):
    """``x`` redistributed to ``placements`` (a no-op when it is there)."""
    if not is_dt(x):
        return x
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def whole_on(x, axis: str = "model"):
    """``x`` replicated on the mesh dim ``axis``: a shard is all-gathered,
    a partial sum all-reduced; the other dims keep their placements. The
    input of a column-parallel product: its gradient comes back as a
    partial sum over ``axis``, which is reduced here in the backward (the
    reduce-scatter of the gather, or an all-reduce where ``x`` was whole
    already), so the stream's gradient stays in the stream's layout."""
    if not is_dt(x):
        return x
    from torch.distributed.tensor import Replicate
    d = mesh_dim(x.device_mesh, axis)
    if d is None:
        return x
    if x.placements[d].is_replicate():
        # identity forward; from_local's backward brings the gradient to
        # x's layout
        return _dtensor().from_local(x.to_local(), x.device_mesh,
                                     x.placements, run_check=False,
                                     shape=x.shape, stride=x.stride())
    pl = list(x.placements)
    pl[d] = Replicate()
    return settle(x, pl)


def resolved(x):
    """``x`` with every pending partial sum reduced (Partial ->
    Replicate); shards stay where they are."""
    if not is_dt(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return settle(x, [Replicate() if p.is_partial() else p
                      for p in x.placements])


def with_dim(placements, dim: int, placement) -> tuple:
    pl = list(placements)
    pl[dim] = placement
    return tuple(pl)


def grad_placements(x, others) -> tuple:
    """The layout of the gradient that a function run on each rank's
    shards leaves for its input ``x``: where ``x`` is whole on a mesh dim
    but another input is split over it, each rank's gradient is a partial
    sum over that dim; elsewhere it is laid out as ``x``."""
    from torch.distributed.tensor import Partial
    out = []
    for d, pl in enumerate(x.placements):
        split = any(is_dt(o) and o.placements[d].is_shard() for o in others)
        out.append(Partial() if pl.is_replicate() and split else pl)
    return tuple(out)


def local(x, others=()):
    """``x.to_local()``, its gradient laid out by ``grad_placements``."""
    return x.to_local(grad_placements=grad_placements(x, others))


def on_shards(fn, out_placements, *args):
    """``fn(*local args)`` on this rank's shards of the DTensor args (the
    other args as they are), its outputs DTensors with
    ``out_placements`` (one sequence of placements per output, or one for
    a single output). Gradients flow through (``local_map``): an input
    whole on a mesh dim that another input splits gets its gradient as a
    partial sum over that dim (``grad_placements``)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dt(a))
    # local_map reads a list as one output's placements, a tuple as one
    # entry per output
    if all(isinstance(p, Placement) for p in out_placements):
        out = list(out_placements)
    else:
        out = tuple(list(p) for p in out_placements)
    in_pl = tuple(tuple(a.placements) if is_dt(a) else None for a in args)
    grad_pl = tuple(grad_placements(a, args) if is_dt(a) else None
                    for a in args)
    return local_map(fn, out_placements=out, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh)(*args)


def from_local(t, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, list(placements), run_check=False)


def group_sum(parts):
    """The sum of 0-d DTensors that may hold partial sums over different
    mesh dims: those with equal placements are added on the rank, then
    each such group is reduced once."""
    groups: dict[tuple, object] = {}
    for s in parts:
        key = tuple(s.placements)
        groups[key] = s if key not in groups else groups[key] + s
    total = None
    for s in groups.values():
        s = resolved(s)
        total = s if total is None else total + s
    return total


def init_fake_group(world: int, rank: int = 0) -> None:
    """The default process group as ``world`` ranks that move no data
    (``torch``'s ``FakeProcessGroup``; a ``HashStore`` in the process, so
    nothing listens on a port): this process is ``rank`` of them. A
    collective returns at once with its output's storage as it was."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common, opts):
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is not None:
            return make(common.group_rank, common.group_size, opts)
        return FakeProcessGroup(common.group_rank, common.group_size)
    if "fake" not in _registered():
        dist.Backend.register_backend("fake", create, extended_api=True,
                                      devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world)


def _registered() -> set[str]:
    import torch.distributed as dist
    return {k.lower() for k in getattr(dist.Backend, "_plugins", {})}


def fake_group_active(world: int) -> bool:
    """Whether the default process group is a fake one of ``world``
    ranks."""
    import torch.distributed as dist
    return (dist.is_initialized() and dist.get_world_size() == world
            and dist.get_backend() == "fake")
