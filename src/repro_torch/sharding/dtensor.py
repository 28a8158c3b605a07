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
- ``rows_of(t, like)``: each rank's batch rows of a whole tensor, placed
  as ``like``'s rows (the positions of a rank's own rows at decode);
- ``write_slot(leaf, slot, new)``: one slot of a cache leaf written in
  place, on the rank that owns it where the slot dim is split (an
  owner-masked write: no host read, no branch on the data);
- ``split_softmax(scores, ok, pv, mesh, dims)``: a softmax over a key
  axis split over mesh dims, merged from each rank's max, sum and
  unnormalised output (the capacity-split decode);
- ``last_along(x, dim)``: the last entry of a dim that may be split (the
  last token of a sequence-sharded stream), as a pending partial sum;
- ``swap(x, d, dst)``, ``regroup(x, target)``: a shard moved between two
  tensor dims by one all-to-all over its mesh dim (the MoE's expert
  all-to-all; the ``pos`` leaf read in K's layout);
- ``split_cols(y, parts)``: a column-parallel product cut into its
  ``parts`` along the last dim, each in the column-parallel layout, by one
  all-to-all over the model axis (Mamba's ``in_proj`` halves, the sLSTM's
  four gates, its up-projection's halves), where a plain ``chunk`` would
  gather the whole product;
- ``remap(placements, dims)``: a layout carried to a tensor whose dims
  sit elsewhere (a state's batch and head dims read by a product's);
- ``replicated(t, like)``, ``rows_like(t, like)``: a whole plain tensor
  on ``like``'s mesh, whole on every rank, or cut to ``like``'s rows;
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


def shard_range(x, dim: int) -> tuple[int, int]:
    """(start, length) of this rank's slice of tensor dim ``dim`` of the
    DTensor ``x``: the mesh dims that split ``dim`` split it in mesh order
    (the outer one first), evenly (the layout rules' divisibility
    guard)."""
    mesh = x.device_mesh
    start, length = 0, x.shape[dim]
    for d, p in enumerate(x.placements):
        if p.is_shard(dim):
            length //= mesh.size(d)
            start += mesh.get_local_rank(d) * length
    return start, length


def split_dims(x, dim: int) -> tuple[int, ...]:
    """The mesh dims that split tensor dim ``dim`` of the DTensor ``x``."""
    return tuple(d for d, p in enumerate(x.placements) if p.is_shard(dim))


def rows_of(t, like):
    """The rows of the whole tensor ``t`` (batch on dim 0) that this rank
    holds of ``like`` (a DTensor whose dim 0 is the same batch), as a
    DTensor placed like ``like``'s rows (whole on the mesh dims that do
    not split them). ``t`` may live on the device; nothing is read
    back."""
    from torch.distributed.tensor import Replicate, Shard
    start, length = shard_range(like, 0)
    pl = [Shard(0) if p.is_shard(0) else Replicate() for p in like.placements]
    return from_local(t[start:start + length], like.device_mesh, pl)


def rows_like(t, like):
    """``t`` (batch on dim 0, whole) as ``like``'s rows: ``rows_of`` on a
    DTensor ``like``, ``t`` itself otherwise."""
    return rows_of(t, like) if is_dt(like) else t


def replicated(t, like):
    """The plain tensor ``t``, whole on every rank, as a replicated DTensor
    on ``like``'s mesh (``t`` itself where ``like`` is plain): a constant
    added to a DTensor (whisper's sinusoids)."""
    if not is_dt(like):
        return t
    from torch.distributed.tensor import Replicate
    mesh = like.device_mesh
    return from_local(t, mesh, [Replicate()] * mesh.ndim)


def remap(placements, dims: dict) -> tuple:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dims[d])``
    (a shard of a dim that ``dims`` does not name becomes ``Replicate``):
    the layout of a tensor whose dims sit elsewhere than another's, as a
    state's batch and heads (``[B, H, hd]``) in a product's ``[B, 1, 4, H,
    hd]``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                 else Replicate() for p in placements)


def split_cols(y, parts: int):
    """``y.chunk(parts, dim=-1)`` of a column-parallel product ``y`` [...,
    parts * n], each part in the column-parallel layout: rank r of the
    model axis (size m) holds columns ``[r n / m, (r + 1) n / m)`` of every
    part. Rank r holds the product's columns ``[r parts n / m, ...)``, so
    each part's blocks live on other ranks (on a model axis of 2 and two
    parts, one rank holds all of the first part): one all-to-all over the
    model axis sends each block of ``n / m`` columns to its owner, where a
    plain ``chunk`` would gather the whole product. Where no mesh dim of
    more than one rank splits the last dim, the parts are cut locally;
    where another mesh dim splits it too, or ``n`` does not divide, it is
    gathered first."""
    if not is_dt(y):
        return y.chunk(parts, dim=-1)
    from torch.distributed.tensor import Replicate
    mesh = y.device_mesh
    last = y.ndim - 1
    md = mesh_dim(mesh, "model")
    wide = tuple(d for d in split_dims(y, last) if mesh.size(d) > 1)
    n = y.shape[-1] // parts
    if wide and (wide != (md,) or n % mesh.size(md)):
        y = settle(y, [Replicate() if p.is_shard(last) else p
                       for p in y.placements])
        wide = ()
    if not wide:
        return tuple(from_local(t, mesh, y.placements)
                     for t in y.to_local().chunk(parts, dim=-1))
    import torch.distributed._functional_collectives as fc
    m, s = mesh.size(md), mesh.get_local_rank(md)
    c = n // m
    # this rank's blocks are k = s * parts + i of the parts * m blocks of
    # c columns; block k is part k // m, owned by rank k % m
    blocks = y.to_local().unflatten(-1, (parts, c)).movedim(-2, 0)
    dest = [(s * parts + i) % m for i in range(parts)]
    order = sorted(range(parts), key=lambda i: dest[i])
    send = [dest.count(j) for j in range(m)]
    # each rank receives one block of every part, from rank
    # (p * m + s) // parts for part p: in part order
    recv = [sum((p * m + s) // parts == r for p in range(parts))
            for r in range(m)]
    out = fc.wait_tensor(fc.all_to_all_single_autograd(
        blocks[order].contiguous(), recv, send, mesh.get_group(md)))
    return tuple(from_local(out[p].contiguous(), mesh, y.placements)
                 for p in range(parts))


def write_slot(leaf, slot, new, dim: int = 1) -> None:
    """``leaf[:, slot] = new`` in place, along ``dim``. ``slot`` is a
    one-element long tensor on the device. On a plain tensor it is
    ``index_copy_``. On a DTensor each rank writes through its local
    shard: where ``dim`` is split, only the rank whose range holds the
    slot changes it (the others write back what they hold, chosen on the
    device). ``new`` is a DTensor, brought to ``leaf``'s layout with
    ``dim`` whole, or a plain tensor that broadcasts to the local
    slice."""
    if is_dt(new):
        from torch.distributed.tensor import Replicate
        new = settle(new, [Replicate() if p.is_shard(dim) else p
                           for p in leaf.placements]).to_local()
    local = leaf.to_local() if is_dt(leaf) else leaf
    shape = list(local.shape)
    shape[dim] = 1
    new = new.to(local.dtype).expand(shape)
    start, length = (shard_range(leaf, dim) if is_dt(leaf)
                     else (0, leaf.shape[dim]))
    if length == leaf.shape[dim]:           # the whole dim on this rank
        local.index_copy_(dim, slot, new)
        return
    import torch
    j = slot - start
    mine = ((j >= 0) & (j < length)).reshape(())
    j = j.clamp(0, length - 1)
    local.index_copy_(dim, j, torch.where(mine, new,
                                          local.index_select(dim, j)))


def all_reduce(t, mesh, dims, op: str = "sum"):
    """The plain tensor ``t``, each rank's part, reduced by ``op`` over the
    mesh dims ``dims`` (one all-reduce a dim; none when ``dims`` is
    empty)."""
    if not dims:
        return t
    from torch.distributed.tensor import Partial, Replicate
    part = [Partial(op) if d in dims else Replicate()
            for d in range(mesh.ndim)]
    return from_local(t, mesh, part).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def split_softmax(scores, ok, pv, mesh, dims):
    """``softmax(scores)`` over the last axis where ``ok`` (bool, like
    ``scores``) holds, applied by ``pv`` (``p -> p @ values``, linear in
    ``p``), when that axis is split over the mesh dims ``dims``: each rank
    holds its own keys. Its max is all-reduced, each rank weights its keys
    by ``exp(s - max)`` (0 where masked, so a rank with no valid key adds
    exactly nothing), and the sums and unnormalised outputs are
    all-reduced together. Returns (``pv(p)`` summed, the sums ``l``,
    ``scores``' shape without its last axis); the caller divides. fp32
    throughout; on one device (no ``dims``) no collective is issued."""
    import torch
    neg = torch.full((), float("-inf"), dtype=scores.dtype,
                     device=scores.device)
    m = torch.where(ok, scores, neg).amax(dim=-1, keepdim=True)
    m = all_reduce(m, mesh, dims, "max")
    p = torch.exp(torch.where(ok, scores - m, neg))
    l = p.sum(dim=-1)
    o = pv(p)
    both = all_reduce(torch.cat([l.reshape(-1), o.reshape(-1)]), mesh, dims)
    return both[l.numel():].reshape(o.shape), both[:l.numel()].reshape(
        l.shape)


def last_along(x, dim: int):
    """``x`` narrowed to the last entry of ``dim``. Where ``dim`` is split
    (a sequence-sharded stream) the rank that holds the last entry gives
    it and the others zeros, so the result is a partial sum over those
    mesh dims: one small all-reduce reduces it, where slicing the DTensor
    would gather the whole dim."""
    if not is_dt(x) or not split_dims(x, dim):
        return x.narrow(dim, x.shape[dim] - 1, 1)
    import torch
    from torch.distributed.tensor import Partial
    mesh = x.device_mesh
    dims = split_dims(x, dim)
    local = x.to_local()
    last = local.narrow(dim, local.shape[dim] - 1, 1)
    owner = all(mesh.get_local_rank(d) == mesh.size(d) - 1 for d in dims)
    if not owner:
        last = torch.zeros_like(last)
    return from_local(last, mesh, [Partial() if d in dims else p
                                   for d, p in enumerate(x.placements)])


def swap(x, d: int, dst: int, outer: tuple[int, ...] = ()):
    """``x``'s shard on mesh dim ``d`` moved from its tensor dim to
    ``dst`` (0 and 1: a batch dim and the dim behind it, as the MoE
    buffers' experts or a cache leaf's slots) by one all-to-all over
    ``d``. No other mesh dim may split the two tensor dims (``regroup``
    gathers them first). Moving slots to rows, ``outer`` gives the sizes
    of the mesh dims (outer first) whose own moves follow this one: the
    rows are sent grouped by their coordinate on ``d`` within each of
    theirs, so that after the last move each rank holds its rows in
    DTensor's order."""
    import math

    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    n, src = mesh.size(d), x.placements[d].dim
    xl = x.to_local()
    if (src, dst) == (0, 1) and not outer:   # send expert block j to rank j
        b, e = xl.shape[:2]
        inp = xl.reshape(b, n, e // n, *xl.shape[2:]).transpose(0, 1)
    elif (src, dst) == (1, 0):   # send row block j to rank j
        rows, rest = xl.shape[0], xl.shape[1:]
        inp = xl.reshape(*outer, n, rows // (math.prod(outer) * n), *rest)
        inp = inp.movedim(len(outer), 0).reshape(n, rows // n, *rest)
    else:
        raise NotImplementedError(f"a shard moved from dim {src} to {dst}")
    out = fc.wait_tensor(fc.all_to_all_single_autograd(
        inp.contiguous().flatten(0, 1), None, None, mesh.get_group(d)))
    out = out.reshape(n, -1, *out.shape[1:])    # [source rank, ...]
    if (src, dst) == (0, 1):
        out = out.flatten(0, 1)                 # rows in rank order
    else:
        out = out.transpose(0, 1).flatten(1, 2)  # expert blocks in order
    return from_local(out, mesh, with_dim(x.placements, d, Shard(dst)))


def regroup(x, target):
    """``x`` redistributed to ``target`` where mesh dims move their shards
    from one tensor dim to another (slots to rows: 1 to 0): the other
    mesh dims that split either of those dims are gathered first, each
    moving shard takes one all-to-all over its mesh dim (``swap``, the
    inner mesh dim first), and the result is split locally into
    ``target``. DTensor's own redistribute would gather the whole tensor
    for such a move where another mesh dim splits the same tensor dim (the
    ``pos`` leaf's capacity over (data, model), read in K's layout with the
    batch over data)."""
    from torch.distributed.tensor import Replicate
    pl, target = tuple(x.placements), tuple(target)
    swaps = [d for d, (a, b) in enumerate(zip(pl, target))
             if a.is_shard() and b.is_shard() and a.dim != b.dim]
    if not swaps:
        return settle(x, target)
    moves = {(pl[d].dim, target[d].dim) for d in swaps}
    if len(moves) > 1:
        raise NotImplementedError(f"a regroup of {pl} to {target} moves "
                                  "shards between more than two dims")
    (src, dst), = moves
    x = settle(x, [Replicate() if e not in swaps and p.is_shard()
                   and p.dim in (src, dst) else p for e, p in enumerate(pl)])
    sizes = [x.device_mesh.size(d) for d in swaps]
    for i in reversed(range(len(swaps))):
        x = swap(x, swaps[i], dst, tuple(sizes[:i]))
    return settle(x, target)


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
