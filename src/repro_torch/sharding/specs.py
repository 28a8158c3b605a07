"""Sharding rules: tree path -> layout spec (port of
``repro.sharding.specs``).

A spec is a plain tuple with one entry per tensor dim — ``None``, a mesh
axis name, or a tuple of names — where the reference returns a
``PartitionSpec`` of the same entries. A mesh is anything with
``axis_names`` and a ``shape`` mapping names to sizes (the reference's
``Mesh``, a test's stand-in, ``placement.persist.MeshMeta``), or a
``torch.distributed`` ``DeviceMesh`` (its ``mesh_dim_names`` and
``shape``). A path is a tuple of dict keys (str) and list indices (int),
the port's tree paths.

Rules name the *trailing* dims of each parameter kind, so stacked-layer
leading axes are handled uniformly. Every axis assignment is
divisibility-guarded: if a dim does not divide over the proposed mesh
axes, the rule falls back (e.g. granite's 40 experts fall back from
expert-parallel to expert-TP over d_ff).

``*_specs_of`` give a tree's specs; ``*_shardings`` turn them into
``(DeviceMesh, placements)`` pairs for ``torch.distributed.tensor``
(``placements``): ``Shard(d)`` on each mesh dim named at tensor dim ``d``,
``Replicate()`` on the others. ``checkpoint/ckpt.py``'s ``restore`` places
leaves by such pairs (``distribute_tensor``), which is the reference's
re-shard at load. The model then computes on those DTensors
(``sharding/dtensor.py``): the train and eval steps, prefill, and decode
on a cache in ``cache_leaf_spec``'s layouts (``batch_shardings`` serves a
bare cache too: its leaves are named ``k``/``v``/``ckv``/``kpe``/``pos``).
These layouts are the reference's ``in_shardings``/``out_shardings``, and
``act_spec_of``, ``mb_shardings`` and the launcher's MoE buffer specs are
its ``with_sharding_constraint`` calls. ``place`` distributes a tree of
whole tensors by such pairs; ``make_leaves`` (``full_leaves`` at
constants) makes each rank's shards directly, so that no rank holds a
whole leaf (``LM.init_cache`` and ``EncDecLM.init_cache`` with
``shardings`` make a decode cache so).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes
from repro_torch.models.config import ModelConfig

Tail = tuple  # trailing-dim spec entries (None | str | tuple[str, ...])


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(entry, str):
        return sizes[entry]
    return int(np.prod([sizes[a] for a in entry]))


def _fit(mesh, shape: tuple[int, ...], tail: Tail) -> tuple:
    """Pad the tail to ndim with leading Nones; drop non-dividing axes."""
    ndim = len(shape)
    tail = tuple(tail)[-ndim:] if len(tail) > ndim else tail
    full = (None,) * (ndim - len(tail)) + tuple(tail)
    out = []
    for dim, entry in zip(shape, full):
        if entry is not None and dim % _axis_size(mesh, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return tuple(out)


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _in_moe(path) -> bool:
    keys = {p for p in path if isinstance(p, str)}
    return "moe" in keys and "shared" not in keys


def _replicated(shape) -> tuple:
    return (None,) * len(shape)


# trailing-dim rules per leaf name (col-parallel, row-parallel, replicated)
_COL = {"wq", "wk", "wv", "wq_b", "wkv_b", "w_up", "w_gate", "up", "wx",
        "in_proj", "w_dt", "w_bc", "skip", "conv_w", "proj"}
_ROW = {"wo", "w_down", "down", "out_proj"}
_VEC = {"bq", "bk", "bv", "b_dt", "gn", "d_skip", "b_if"}


def param_spec_for(cfg: ModelConfig, mesh, path, shape) -> tuple:
    shape = tuple(shape)
    name = _leaf_name(path)
    mp = "model"
    msize = axis_sizes(mesh)[mp]
    # Attention TP must be HEAD-ALIGNED: sharding [*, n_heads*head_dim] is
    # only usable if whole heads land on each shard — otherwise the [S,S]
    # score tensors are resharded (a 14 GiB all-reduce on qwen2's 14 heads
    # over model=16 in the reference). Misaligned archs replicate attention
    # weights and parallelize attention over batch only.
    heads_ok = cfg.num_heads % msize == 0
    kv_ok = (cfg.num_kv_heads % msize == 0) and heads_ok
    if _in_moe(path) and name in ("w_gate", "w_up", "w_down"):
        # expert-parallel: E over (data, model) when it divides (deepseek's
        # 256e — required to fit), else E over model (granite's padded 48e),
        # else expert-TP over the FFN dim.
        e = shape[-3]
        if e % _axis_size(mesh, ("data", mp)) == 0:
            return _fit(mesh, shape, (("data", mp), None, None))
        if e % msize == 0:
            return _fit(mesh, shape, (mp, None, None))
        if name == "w_down":
            return _fit(mesh, shape, (None, mp, None))
        return _fit(mesh, shape, (None, None, mp))
    if name == "embed":
        return _fit(mesh, shape, (mp, None))
    if name == "head":
        return _fit(mesh, shape, (None, mp))
    if name == "router":
        return _replicated(shape)
    if name == "a_log":
        return _fit(mesh, shape, (mp, None))
    if name in ("wq", "wq_b", "wkv_b"):
        return _fit(mesh, shape, (None, mp)) if heads_ok else \
            _replicated(shape)
    if name in ("wk", "wv"):
        # the reference path repeats KV to full query heads, so KV
        # projections can stay sharded only when the *query* heads align
        return _fit(mesh, shape, (None, mp)) if kv_ok else _replicated(shape)
    if name == "wo":
        return _fit(mesh, shape, (mp, None)) if heads_ok else \
            _replicated(shape)
    if name == "bq":
        return _fit(mesh, shape, (mp,)) if heads_ok else _replicated(shape)
    if name in ("bk", "bv"):
        return _fit(mesh, shape, (mp,)) if kv_ok else _replicated(shape)
    if name in _COL:
        return _fit(mesh, shape, (None, mp))
    if name in _ROW:
        return _fit(mesh, shape, (mp, None))
    if name in _VEC:
        return _fit(mesh, shape, (mp,))
    return _replicated(shape)   # norms, small tensors: replicated


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, with the
    port's paths (dict keys and list indices)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def placements(mesh, spec: tuple) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on a
    ``DeviceMesh``: ``Shard(d)`` on every mesh dim that ``spec`` names at
    tensor dim ``d`` (a tuple entry shards ``d`` over each of its axes, in
    mesh order), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _shardings(mesh, specs) -> Any:
    """``(mesh, placements)`` for every spec of a spec tree (dicts and
    lists of specs; a spec is a tuple)."""
    if isinstance(specs, dict):
        return {k: _shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_shardings(mesh, v) for v in specs]
    return mesh, placements(mesh, specs)


def param_specs_of(cfg: ModelConfig, mesh, param_specs) -> Any:
    return map_with_path(
        lambda path, leaf: param_spec_for(cfg, mesh, path, leaf.shape),
        param_specs)


def param_shardings(cfg: ModelConfig, mesh, param_specs) -> Any:
    return _shardings(mesh, param_specs_of(cfg, mesh, param_specs))


# ---------------------------------------------------------------------------
# batch / cache / state shardings
# ---------------------------------------------------------------------------

def batch_specs_of(cfg: ModelConfig, mesh, batch_specs) -> Any:
    dp = dp_axes(mesh)

    def f(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if name == "position":
            return ()
        if name == "positions":           # [3, B, S]
            return _fit(mesh, shape, (None, dp, None))
        if name in ("tokens", "frames", "patch_embeds"):
            return _fit(mesh, shape, (dp,) + (None,) * (len(shape) - 1))
        return cache_leaf_spec(cfg, mesh, path, leaf)
    return map_with_path(f, batch_specs)


def batch_shardings(cfg: ModelConfig, mesh, batch_specs) -> Any:
    return _shardings(mesh, batch_specs_of(cfg, mesh, batch_specs))


def cache_leaf_spec(cfg: ModelConfig, mesh, path, leaf) -> tuple:
    """KV caches / SSM states: batch over dp when divisible; otherwise the
    long-context axis (cache capacity) spreads over dp; heads/inner over
    model when divisible, else capacity over model too."""
    dp = dp_axes(mesh)
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    mp = "model"

    def fit_first(cands: list[Tail]) -> tuple:
        """Pick the candidate with the highest shard degree — taking the
        first partial fit left internlm2's 825 GB KV cache 16-way (151 GiB/
        device) when a 256-way candidate was next in line."""
        best, best_deg = _replicated(shape), 1
        for tail in cands:
            p = _fit(mesh, shape, tail)
            deg = 1
            for entry in p:
                if entry is not None:
                    deg *= _axis_size(mesh, entry)
            if deg > best_deg:
                best, best_deg = p, deg
        return best

    if name in ("k", "v"):          # [L?, B, C, nkv, hd]
        return fit_first(
            [(dp, None, mp, None), (dp, mp, None, None),
             (None, (dp + (mp,)), None, None), (None, dp, None, None)])
    if name in ("ckv", "kpe"):      # [L?, B, C, r] (MLA latent)
        return fit_first(
            [(dp, mp, None), (None, (dp + (mp,)), None), (None, dp, None)])
    if name in ("ck", "cv"):        # whisper cross KV [B, F, nkv, hd]
        return fit_first([(dp, None, mp, None), (dp, None, None, None)])
    if name == "pos":               # [L?, B, C]
        return fit_first([(dp, None), (None, dp + (mp,)), (None, dp)])
    if name == "conv":              # [L?, B, K-1, inner]
        return fit_first([(dp, None, mp), (None, None, mp)])
    if name == "h":                 # mamba [L?, B, inner, state]
        return fit_first([(dp, mp, None), (None, mp, None)])
    if name in ("c", "n", "m"):     # mlstm/slstm states [L?, B, H, ...]
        return fit_first(
            [(dp, mp) + (None,) * (len(shape) - 2),
             (dp,) + (None,) * (len(shape) - 1)])
    return _replicated(shape)


def cache_leaf_sharding(cfg: ModelConfig, mesh, path, leaf):
    return mesh, placements(mesh, cache_leaf_spec(cfg, mesh, path, leaf))


def kv_pool_spec(cfg: ModelConfig, mesh, page_size: int) -> tuple:
    """Layout spec for a paged KV pool ``[L, pages, page_size, nkv, hd]``.

    KV heads shard over 'model' when they divide; the page axis stays
    replicated — the page table, not the sharding, is the placement
    mechanism there. This is the layout metadata a fabric stamps onto peer
    page-range exports (persistence tier, DESIGN.md §9) so an importer can
    check the bytes were produced under a compatible sharding.
    """
    shape = (cfg.num_layers, 1, page_size, cfg.num_kv_heads, cfg.head_dim_)
    return _fit(mesh, shape, (None, None, None, "model", None))


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state sharding
# ---------------------------------------------------------------------------

def zero_spec(mesh, pspec: tuple, shape: tuple[int, ...]) -> tuple:
    """Extend a param spec: shard the largest free dim over 'data'
    (uniform ZeRO baseline; the BWAP-weighted variant lives in zero.py).
    No-op if the spec already consumes the data axis (e.g. deepseek expert
    tensors sharded E x ('data','model'))."""
    shape = tuple(shape)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    used: set[str] = set()
    for entry in entries:
        if isinstance(entry, str):
            used.add(entry)
        elif entry is not None:
            used.update(entry)
    if "data" in used:
        return tuple(entries)
    data = axis_sizes(mesh)["data"]
    best, best_dim = -1, -1
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if entry is None and dim % data == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim >= 0:
        entries[best_dim] = "data"
    return tuple(entries)


def grad_specs_of(cfg: ModelConfig, mesh, param_specs) -> Any:
    """ZeRO-sharded gradient layout: param spec + 'data' extension."""
    def f(path, leaf):
        pspec = param_spec_for(cfg, mesh, path, leaf.shape)
        return zero_spec(mesh, pspec, leaf.shape)
    return map_with_path(f, param_specs)


def grad_shardings(cfg: ModelConfig, mesh, param_specs) -> Any:
    return _shardings(mesh, grad_specs_of(cfg, mesh, param_specs))


def opt_specs_of(cfg: ModelConfig, mesh, opt_state_specs) -> Any:
    """Specs for the optimizer-state tree (``init_opt_state``'s layout).

    fp32 moments / master params: param spec + ZeRO 'data' extension.
    int8 block-quantized moments ({"q","scale"}): the aligned layout
    inherits the param's spec on the leading dims; the flat block dim is
    sharded over as many mesh axes as divide (671B-scale states must
    spread over the whole pod, not just the data axis).
    """
    names = axis_names(mesh)

    def f(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if name == "step":
            return ()
        if name in ("q", "scale"):
            # sharding-aligned layout: q [*param_lead, nb, block],
            # scale [*param_lead, nb] — inherit the PARAM's spec on the
            # leading dims (the path minus m/v/q/scale names the param),
            # extend with None
            parent = tuple(p for p in path if isinstance(p, str)
                           and p not in ("q", "scale", "m", "v"))
            extra = 2 if name == "q" else 1
            lead = shape[:len(shape) - extra]
            if lead:
                param_shape = lead + (int(np.prod(shape[len(lead):])),)
                pspec = param_spec_for(cfg, mesh, parent, param_shape)
                entries = (list(pspec) + [None] * len(param_shape))[
                    :len(param_shape) - 1]
                spec = tuple(entries) + (None,) * extra
                return zero_spec(mesh, spec, shape)
            # flat fallback: shard the block dim over whatever divides
            for axes in (("pod", "data", "model"), ("data", "model"),
                         ("data",), ("model",)):
                axes = tuple(a for a in axes if a in names)
                if axes and shape[0] % _axis_size(mesh, axes) == 0:
                    return (axes,) + (None,) * (len(shape) - 1)
            return _replicated(shape)
        pspec = param_spec_for(cfg, mesh, path, shape)
        return zero_spec(mesh, pspec, shape)
    return map_with_path(f, opt_state_specs)


def opt_shardings(cfg: ModelConfig, mesh, opt_state_specs) -> Any:
    return _shardings(mesh, opt_specs_of(cfg, mesh, opt_state_specs))


# ---------------------------------------------------------------------------
# activations and microbatches (the reference launcher's constraints)
# ---------------------------------------------------------------------------

def act_spec_of(mesh) -> tuple:
    """The residual stream's spec under ``seq_shard_activations``: batch
    over the data-parallel axes, sequence over model (the reference's
    ``P(dp_axes, "model", None)``)."""
    return (dp_axes(mesh), "model", None)


def mb_shardings(batch_shardings) -> Any:
    """Microbatch layouts from a batch's shardings tree, the reference's
    ``P(None, *batch_spec)``: after the ``[accum, B/accum, ...]`` reshape
    each ``Shard(d)`` is ``Shard(d + 1)``, behind the microbatch dim."""
    from torch.distributed.tensor import Shard
    if _is_pair(batch_shardings):
        mesh, pl = batch_shardings
        return mesh, tuple(Shard(p.dim + 1) if p.is_shard() else p
                           for p in pl)
    if isinstance(batch_shardings, dict):
        return {k: mb_shardings(v) for k, v in batch_shardings.items()}
    return type(batch_shardings)(mb_shardings(v)
                                 for v in batch_shardings)


# ---------------------------------------------------------------------------
# trees on a DeviceMesh
# ---------------------------------------------------------------------------

def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 \
        and hasattr(x[0], "mesh_dim_names")


def map_pairs(fn, tree, shardings) -> Any:
    """``fn(leaf, mesh, placements)`` over a tree and its shardings tree
    (``*_shardings``: the same structure, a ``(mesh, placements)`` pair
    at each leaf)."""
    if _is_pair(shardings):
        return fn(tree, *shardings)
    if isinstance(tree, dict):
        return {k: map_pairs(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_pairs(fn, v, s)
                          for v, s in zip(tree, shardings))
    raise TypeError(f"no (mesh, placements) pair for a {type(tree)}")


def place(tree, shardings) -> Any:
    """Each whole tensor of ``tree`` distributed by its pair
    (``distribute_tensor`` on the mesh's device type): every rank holds
    the same tensor and cuts its own shard from it, so no data moves."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, mesh, placements):
        import torch
        t = torch.as_tensor(t).to(mesh.device_type)
        return distribute_tensor(t, mesh, list(placements),
                                 src_data_rank=None)
    return map_pairs(put, tree, shardings)


def local_shape(shape, mesh, placements) -> tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor under ``placements``
    (every sharded dim divides: the rules' divisibility guard)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def make_leaves(specs_tree, shardings, init) -> Any:
    """DTensors shaped like ``specs_tree``'s leaves (anything with
    ``shape`` and ``dtype``) placed by ``shardings``, each rank making
    only its own shard: ``init(local_shape, dtype, device)`` gives the
    local tensor, so no rank ever holds a whole leaf."""
    from torch.distributed.tensor import DTensor

    def make(leaf, mesh, placements):
        local = init(local_shape(tuple(leaf.shape), mesh, placements),
                     leaf.dtype, mesh.device_type)
        return DTensor.from_local(local, mesh, list(placements),
                                  run_check=False)
    return map_pairs(make, specs_tree, shardings)


def full_leaves(specs_tree, shardings, fill) -> Any:
    """``make_leaves`` with each leaf at a constant: ``fill(path)``, its
    path in ``specs_tree`` (a decode cache's empty state: positions at -1,
    a recurrent stabiliser at its own start, the rest zero)."""
    import torch

    def walk(tree, pair, path):
        if _is_pair(pair):
            return make_leaves(tree, pair, lambda shape, dtype, dev:
                               torch.full(shape, fill(path), dtype=dtype,
                                          device=dev))
        if isinstance(tree, dict):
            return {k: walk(v, pair[k], path + (k,)) for k, v in tree.items()}
        return type(tree)(walk(v, s, path + (i,))
                          for i, (v, s) in enumerate(zip(tree, pair)))
    return walk(specs_tree, shardings, ())
