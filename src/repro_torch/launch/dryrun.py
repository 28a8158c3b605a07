"""The dry-run (port of ``repro.launch.dryrun``): what a production cell
(architecture x input shape x mesh) costs on the H100, from shapes alone.

For every cell the step runs on fake tensors (``roofline/counter.py``), so
nothing is allocated at any width, on the chunked attention path
(``attn_impl="reference"``), as the reference lowers it; no CUDA kernel
runs on fake tensors and the counts do not depend on the device. The
record holds:

- ``memory``: the argument bytes per device, exact: the shard shapes of
  params, optimizer state, batch and cache under the port's layouts
  (``sharding/specs.py``). The temporaries: the trace's peak live bytes
  over one per-device microbatch (global batch / dp / ``accum_steps_for``;
  a gradient at its layout's share of the param), with the gradient
  accumulator, and over the optimizer update on the ZeRO-sharded state.
  ``total_bytes_per_device`` is the reference's sum (arguments + outputs
  + temporaries - aliases); ``peak_bytes_per_device`` the eager step's
  own peak (arguments + the larger phase's live bytes).
- ``full``, for every cell on a mesh of more than one device (every
  family: dense, MoE with MLA, VLM, hybrid, SSM, encoder-decoder; train,
  prefill and decode, ``long_500k`` included): rank 0's sharded step,
  traced (``"partition": "traced"``). A fake process group of the
  mesh's size (``sharding/dtensor.init_fake_group``) carries a
  ``DeviceMesh``; params, optimizer
  state and batch (a decode cell's cache, tokens and position; a VLM's
  patch embeddings and M-RoPE positions; an encoder-decoder's frames,
  and its cache with the cross K/V) are DTensors of fake shards placed
  by ``sharding/specs.py``, the cache in the reference's
  ``cache_leaf_sharding`` layouts; the launcher's constraints are set as
  the reference's for that kind (``act_spec`` under
  ``seq_shard_activations`` for train and prefill, never for an
  encoder-decoder; the MoE buffer specs when the experts divide over
  (data, model)). A train cell runs
  ``make_train_step`` with ``grad_specs`` and ``mb_specs`` under
  accumulation, a prefill or decode cell ``registry.step_fn``, as the
  reference jits it; a decode step writes its cache in place, which the
  record counts as the reference's donated cache (an output aliased to
  its argument). FLOPs and bytes are the rank's (``roofline/counter.py``:
  ``RankFlops``, ``ByteCounter``), the peak is the arguments plus the
  trace's live peak, and the collectives are counted as issued
  (``CollectiveLog``: kind, result bytes, mesh dims); a decode record
  also gives ``pos_read_bytes``, what its reads of the ``pos`` leaves in
  the K/V leaves' layout move.
- ``full``, on a one-device mesh: the plain step's FLOPs and bytes (the
  microbatch's counts x accum plus the update's; ``"partition":
  "exact"``, no collective). ``collectives`` still builds a step's
  collectives from the layouts alone (ZeRO's, tensor parallelism's
  partial sums, the vocab-sharded embedding's and head's, MoE
  all-to-alls), a model no cell's record uses now.
- ``fragments`` (one-device cells): each of ``model.fragments`` traced
  once (train ones with their backward, all-ones cotangents). Eager
  PyTorch runs every trip of a loop in the full trace, so
  ``roofline_record`` combines the full part alone (``"trips_in_full":
  true``).
- ``roofline``: ``roofline/analyze.py``'s terms on the H100 table.

Meshes are stand-ins (axis names and sizes): single (16, 16) = (data,
model), multi (2, 16, 16) = (pod, data, model); only a traced cell builds
a process group, a fake one, and only when none is initialised (else the
default group must be a fake one of the mesh's size, which it then
reuses). ``run_cell`` also takes any stand-in mesh (or ``DeviceMesh``) and
a batch and sequence.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
          --mesh both          # writes build/dryrun_torch/<cell>.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.device import dtype_of
from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.roofline import analyze, counter
from repro_torch.sharding import dtensor as dtn
from repro_torch.sharding import specs as sh
from repro_torch.train import optimizer as opt
from repro_torch.train.trainstep import (accum_steps_for, accumulated_grads,
                                         make_train_step, opt_config_for)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "dryrun_torch"


@dataclasses.dataclass(frozen=True)
class StandInMesh:
    """A mesh's axis names and sizes, as ``sharding/specs.py`` reads
    them."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def production_mesh(multi_pod: bool = False) -> StandInMesh:
    """Single: (16, 16) = (data, model), 256 devices. Multi: (2, 16, 16) =
    (pod, data, model), 512 devices."""
    if multi_pod:
        return StandInMesh(("pod", "data", "model"), (2, 16, 16))
    return StandInMesh(("data", "model"), (16, 16))


# -- bytes under a layout ------------------------------------------------------

def sharded_bytes(tree, spec_tree, mesh) -> int:
    """Bytes per device of a tree of tensors (or meta tensors) whose specs
    are ``spec_tree`` (the same structure, a spec tuple at each leaf)."""
    if isinstance(tree, dict):
        return sum(sharded_bytes(tree[k], spec_tree[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(sharded_bytes(t, s, mesh) for t, s in zip(tree, spec_tree))
    n = tree.element_size()
    for dim, entry in zip(tree.shape, spec_tree):
        n *= dim // sh._axis_size(mesh, entry)
    return n


def _shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    return tuple(d // sh._axis_size(mesh, e) for d, e in zip(shape, spec))


def argument_bytes(cfg: ModelConfig, shape: registry.Shape, mesh, *,
                   batch: int | None = None, seq: int | None = None,
                   model=None) -> dict[str, int]:
    """Per-device bytes of the step's arguments: ``params``, ``opt_state``
    (train cells) and ``batch`` (tokens, frames, patches, positions; a
    decode cell's cache, tokens and position)."""
    model = model or registry.make_model(cfg)
    pspecs = model.param_specs()
    bspecs = registry.input_specs(cfg, shape, batch=batch, seq=seq)
    out = {"params": sharded_bytes(
               pspecs, sh.param_specs_of(cfg, mesh, pspecs), mesh),
           "opt_state": 0,
           "batch": sharded_bytes(
               bspecs, sh.batch_specs_of(cfg, mesh, bspecs), mesh)}
    if shape.kind == "train":
        ospecs = opt.opt_state_specs(opt_config_for(cfg), pspecs)
        out["opt_state"] = sharded_bytes(
            ospecs, sh.opt_specs_of(cfg, mesh, ospecs), mesh)
    return out


# -- collectives from the layouts --------------------------------------------

class _Ops:
    """Collectives of one step, merged by (kind, bytes, group)."""

    def __init__(self, mesh):
        self.names = axis_names(mesh)
        self.sizes = tuple(axis_sizes(mesh)[a] for a in self.names)
        self.counts: dict[tuple, int] = {}

    def add(self, kind: str, nbytes: float, axes, count: int) -> None:
        dims = tuple(self.names.index(a) for a in axes)
        gsize, crosses = analyze.group_info(self.sizes, dims)
        if gsize <= 1 or count <= 0 or nbytes <= 0:
            return
        key = (kind, int(nbytes), gsize, crosses)
        self.counts[key] = self.counts.get(key, 0) + int(count)

    def as_list(self) -> list[dict]:
        return [dict(kind=k, result_bytes=b, group_size=g, crosses_pod=c,
                     count=n) for (k, b, g, c), n in self.counts.items()]


def _leaves_with_paths(tree) -> list[tuple]:
    out = []
    sh.map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def collectives(cfg: ModelConfig, mesh, model, pspecs, kind: str,
                accum: int, b: int, s: int) -> list[dict]:
    """The step's collectives per device, from the layouts, at a
    per-device microbatch ``b`` x ``s`` tokens (s = 1 for decode)."""
    ops = _Ops(mesh)
    elt = dtype_of(cfg.compute_dtype).itemsize
    train = kind == "train"
    mb = accum if train else 1                 # microbatches a step
    scanned = {i for i, g in enumerate(getattr(model, "groups", ()))
               if g.scanned}
    for path, leaf in _leaves_with_paths(pspecs):
        shape = tuple(leaf.shape)
        spec = sh.param_spec_for(cfg, mesh, path, shape)
        name = sh._leaf_name(path)
        top = path[0]
        if top == "enc" and kind == "decode":
            continue                           # decode runs the decoder only
        if top == "mtp" and not train:
            continue                           # the MTP head trains only
        layers = shape[0] if top == "groups" and path[1] in scanned else 1
        tokens = b * (cfg.enc_frames if top == "enc" else s)
        # forward, backward (the conjugate collective), remat's recompute
        passes = 1 + (2 if train and cfg.remat != "none"
                      and top == "groups" and path[1] in scanned
                      else 1 if train else 0)
        if name == "embed":
            if spec[0] == "model":             # vocab-sharded lookup
                ops.add("all-reduce", tokens * shape[1] * elt, ("model",),
                        mb)
            continue
        if sh._in_moe(path) and name in ("w_gate", "w_up", "w_down"):
            if name != "w_down":
                continue
            if spec[-3] == ("data", "model"):  # expert-parallel all-to-alls
                cap = moe.capacity(s, cfg)
                ops.add("all-to-all", b * shape[-3] * cap * shape[-1] * elt,
                        ("data", "model"), 2 * layers * passes * mb)
                continue
            if spec[-3] == "model":            # experts over model: sum
                ops.add("all-reduce", tokens * shape[-1] * elt, ("model",),
                        layers * passes * mb)
                continue
        if len(shape) >= 2 and spec[-2] == "model":    # partial sums
            ops.add("all-reduce", tokens * shape[-1] * elt, ("model",),
                    layers * passes * mb)
    # the vocab-sharded head: the hidden states' gradient (train) or the
    # gathered last-token logits (prefill, decode)
    if "head" in pspecs:
        head = pspecs["head"]
        vocab_sharded = sh.param_spec_for(cfg, mesh, ("head",),
                                          head.shape)[1] == "model"
    else:                                      # tied: the embedding's rows
        head = pspecs["embed"].T
        vocab_sharded = sh.param_spec_for(
            cfg, mesh, ("embed",), pspecs["embed"].shape)[0] == "model"

    if vocab_sharded:
        if train:
            ops.add("all-reduce", b * s * head.shape[0] * elt, ("model",),
                    mb)
        else:
            ops.add("all-gather", b * head.shape[1] * elt, ("model",), 1)
    if train:
        _grad_collectives(cfg, mesh, pspecs, ops, accum)
    return ops.as_list()


def _grad_collectives(cfg, mesh, pspecs, ops: _Ops, accum: int) -> None:
    """ZeRO per leaf: the grads reduce-scattered over data (each
    microbatch), all-reduced over the other data-parallel axes, and the
    updated shard all-gathered back; a leaf ZeRO cannot split is
    all-reduced over the data-parallel axes its layout leaves free."""
    for path, leaf in _leaves_with_paths(pspecs):
        shape = tuple(leaf.shape)
        spec = sh.param_spec_for(cfg, mesh, path, shape)
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        red = [a for a in dp_axes(mesh) if a not in used]
        local = math.prod(_shard_shape(shape, spec, mesh)) \
            * leaf.element_size()
        if sh.zero_spec(mesh, spec, shape) != tuple(spec) + (None,) * (
                len(shape) - len(spec)):
            shard = local // axis_sizes(mesh)["data"]
            ops.add("reduce-scatter", shard, ("data",), accum)
            ops.add("all-reduce", shard, [a for a in red if a != "data"],
                    accum)
            ops.add("all-gather", local, ("data",), 1)
        elif red:
            ops.add("all-reduce", local, red, accum)


# -- the sharded trace ------------------------------------------------------------

def traced(cfg: ModelConfig, shape: registry.Shape) -> bool:
    """Whether the cell's record, on a mesh of more than one device, is
    rank 0's sharded step, traced: every cell of every family (dense, MoE
    with MLA, VLM, hybrid, SSM and encoder-decoder; train, prefill and
    decode, ``long_500k`` included). On one device the step is the plain
    one."""
    return True


def launcher_constraints(model, cfg: ModelConfig, mesh, kind: str):
    """The reference launcher's layout hooks on ``mesh``: ``act_spec``
    under ``seq_shard_activations`` (train and prefill; not for an
    encoder-decoder), the MoE buffer specs when the experts divide over
    (data, model). Returns a function that clears them."""
    sizes = axis_sizes(mesh)
    if cfg.seq_shard_activations and kind in ("train", "prefill") \
            and not cfg.enc_dec:
        model.act_spec = sh.act_spec_of(mesh)
    if cfg.moe and cfg.moe.num_experts % (sizes["data"]
                                          * sizes["model"]) == 0:
        moe.set_buf_spec((None, ("data", "model"), None, None),
                         (dp_axes(mesh), None, None))
    else:
        moe.set_buf_spec(None)

    def clear():
        model.act_spec = None
        moe.set_buf_spec(None)
    return clear


def device_mesh(mesh, device_type: str | None = None):
    """A ``DeviceMesh`` with ``mesh``'s axes (``mesh`` itself if it is
    one) over the default process group."""
    if hasattr(mesh, "mesh_dim_names"):
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    return init_device_mesh(device_type, tuple(axis_sizes(mesh).values()),
                            mesh_dim_names=axis_names(mesh))


def sharded_step_trace(cfg: ModelConfig, model, mesh, b: int, s: int,
                       accum: int) -> counter.Counts:
    """Rank 0's counts of one ``make_train_step`` step on ``mesh`` (a
    ``DeviceMesh``) at global batch ``b`` x ``s`` tokens: fake shards,
    the reference launcher's constraints and train-step specs."""
    shape = registry.SHAPES["train_4k"]
    pspecs = model.param_specs()
    ocfg = opt_config_for(cfg)
    ospecs = opt.opt_state_specs(ocfg, pspecs)
    bspecs = registry.input_specs(cfg, shape, batch=b, seq=s)
    shardings = (sh.param_shardings(cfg, mesh, pspecs),
                 sh.opt_shardings(cfg, mesh, ospecs),
                 sh.batch_shardings(cfg, mesh, bspecs))
    step = make_train_step(
        model, ocfg, accum,
        sh.grad_shardings(cfg, mesh, pspecs) if accum > 1 else None,
        sh.mb_shardings(shardings[2]) if accum > 1 else None)
    clear = launcher_constraints(model, cfg, mesh, "train")
    try:
        return counter.trace_sharded(step, (pspecs, ospecs, bspecs),
                                     shardings)
    finally:
        clear()


def sharded_infer_trace(cfg: ModelConfig, model, mesh,
                        shape: registry.Shape, b: int,
                        s: int) -> counter.Counts:
    """Rank 0's counts of one ``registry.step_fn`` call of a prefill or
    decode cell on ``mesh`` (a ``DeviceMesh``) at global batch ``b`` and
    sequence (a decode cell's cache capacity) ``s``, as the reference
    jits it: params by ``param_shardings``, the batch (a decode cell's
    cache, tokens and position) by ``batch_shardings``, the launcher's
    constraints for that kind; no gradient. A decode step writes its cache
    in place, so the trace makes no second copy of it."""
    pspecs = model.param_specs()
    bspecs = registry.input_specs(cfg, shape, batch=b, seq=s)
    shardings = (sh.param_shardings(cfg, mesh, pspecs),
                 sh.batch_shardings(cfg, mesh, bspecs))
    clear = launcher_constraints(model, cfg, mesh, shape.kind)
    try:
        with torch.no_grad():
            return counter.trace_sharded(
                registry.step_fn(cfg, shape, model), (pspecs, bspecs),
                shardings)
    finally:
        clear()


def group_dims(mesh):
    """``name -> mesh dim`` of process groups: a group is the mesh dim
    whose group on this rank has its ranks (DTensor may issue over the
    groups of another mesh of the same layout, whose names differ)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    by_ranks = {tuple(dist.get_process_group_ranks(mesh.get_group(d))): d
                for d in range(mesh.ndim)}
    return lambda name: by_ranks[tuple(dist.get_process_group_ranks(
        _resolve_process_group(name)))]


def issued(mesh, ops) -> list[dict]:
    """``CollectiveLog`` records as the roofline's collectives: merged by
    (kind, result bytes, mesh dims), each with its group's size and
    whether it crosses pods."""
    names = axis_names(mesh)
    sizes = tuple(axis_sizes(mesh)[a] for a in names)
    dim_of = group_dims(mesh)
    counts: dict[tuple, int] = {}
    for kind, nbytes, group, _, _ in ops:
        key = (kind, nbytes, (dim_of(group),))
        counts[key] = counts.get(key, 0) + 1
    out = []
    for (kind, nbytes, ds), n in counts.items():
        gsize, crosses = analyze.group_info(sizes, ds)
        out.append(dict(kind=kind, result_bytes=nbytes, group_size=gsize,
                        crosses_pod=crosses,
                        mesh_dims=[names[d] for d in ds], count=n))
    return out


def _traced_cell(cfg, shape, mesh, b, s, model, args, rec) -> tuple:
    """(memory, full) of a traced cell: rank 0's sharded step on a fake
    process group of the mesh's size. A decode cell's cache is the
    reference's donated argument: written in place, counted once, as an
    output aliased to it."""
    import math

    import torch.distributed as dist
    sizes = axis_sizes(mesh)
    world = math.prod(sizes.values())
    own = not dist.is_initialized()
    if own:
        dtn.init_fake_group(world)
    elif not dtn.fake_group_active(world):
        raise RuntimeError(
            f"a traced cell needs a fake process group of {world} ranks; "
            f"the default group is {dist.get_backend()} with "
            f"{dist.get_world_size()}")
    try:
        dmesh = device_mesh(mesh)
        if shape.kind == "train":
            dp = math.prod(sizes[a] for a in dp_axes(mesh))
            accum = accum_steps_for(cfg, b, s, dp, sizes["model"])
            rec["accum_steps"] = accum
            c = sharded_step_trace(cfg, model, dmesh, b, s, accum)
        else:
            c = sharded_infer_trace(cfg, model, dmesh, shape, b, s)
        colls = issued(dmesh, c.collectives)
    finally:
        if own:
            dist.destroy_process_group()
    arg_total = sum(args.values())
    alias = 0
    if shape.kind == "train":
        outputs = args["params"] + args["opt_state"]
    else:
        logits = c.out[0] if shape.kind == "decode" else c.out
        logits = logits.to_local() if dtn.is_dt(logits) else logits
        outputs = logits.numel() * logits.element_size()
        if shape.kind == "decode":
            bspecs = registry.input_specs(cfg, shape, batch=b, seq=s)
            alias = sharded_bytes(bspecs["cache"], sh.batch_specs_of(
                cfg, mesh, {"cache": bspecs["cache"]})["cache"], mesh)
            outputs += alias
    mem = {"argument_size_in_bytes": arg_total,
           "output_size_in_bytes": outputs,
           "temp_size_in_bytes": int(max(c.peak - (outputs - alias), 0)),
           "alias_size_in_bytes": alias,
           "peak_bytes_per_device": int(arg_total + c.peak)}
    full = {"flops": c.flops, "bytes": c.bytes, "collectives": colls,
            "n_collectives": sum(x["count"] for x in colls),
            "partition": "traced"}
    if shape.kind == "decode":
        # decode reads each layer's pos leaf in its K/V (or latent)
        # leaf's layout: the int32 collectives are those reads
        full["pos_read_bytes"] = sum(n for _, n, _, _, dt in c.collectives
                                     if dt == torch.int32)
    return mem, full


# -- the cell ------------------------------------------------------------------

def _grad_wrap(fn):
    """``fn`` with its backward: the grads of every float arg under
    all-ones cotangents (the reference's ``_grad_wrap``)."""
    def wrapped(*args):
        ins = [t for t in opt.tree_leaves(args)
               if isinstance(t, torch.Tensor) and t.requires_grad]
        outs = [o for o in opt.tree_leaves(fn(*args))
                if isinstance(o, torch.Tensor) and o.requires_grad]
        return torch.autograd.grad(outs, ins,
                                   [torch.ones_like(o) for o in outs],
                                   allow_unused=True)
    return wrapped


def _part(c: counter.Counts, split: int) -> dict:
    return {"flops": c.flops / split, "bytes": c.bytes / split}


def _grad_share(cfg, mesh, model, pspecs):
    """scale(t) for the microbatch trace: a storage shaped like a param
    (a gradient, or one layer's slice of a stacked one) counts at the
    param layout's share; anything else whole."""
    share: dict[tuple, float] = {}
    scanned = {i for i, g in enumerate(getattr(model, "groups", ()))
               if g.scanned}
    for path, leaf in _leaves_with_paths(pspecs):
        shape = tuple(leaf.shape)
        spec = sh.param_spec_for(cfg, mesh, path, shape)
        frac = math.prod(_shard_shape(shape, spec, mesh)) / max(
            math.prod(shape), 1)
        keys = [(shape, leaf.dtype)]
        if path[0] == "groups" and path[1] in scanned:
            keys.append((shape[1:], leaf.dtype))
        for k in keys:
            share[k] = max(share.get(k, 0.0), frac)
    return lambda t: share.get((tuple(t.shape), t.dtype), 1.0)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, *, mesh=None, batch: int | None = None,
             seq: int | None = None) -> dict:
    """The record of one cell: on a production mesh, or on ``mesh`` (any
    stand-in) at ``batch`` x ``seq`` (the shape's by default)."""
    cfg = registry.get_config(arch)
    shape = registry.SHAPES[shape_name]
    ok, reason = registry.cell_supported(cfg, shape)
    mesh_name = ("multi" if multi_pod else "single") if mesh is None \
        else "x".join(str(n) for n in axis_sizes(mesh).values())
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "timestamp": time.time()}
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    sizes = axis_sizes(mesh)
    chips = math.prod(sizes.values())
    dp = math.prod(sizes[a] for a in dp_axes(mesh))
    mp = sizes["model"]
    b = batch if batch is not None else shape.global_batch
    s = seq if seq is not None else shape.seq_len
    b_local = b // dp if b % dp == 0 else b     # _fit replicates otherwise
    model = registry.make_model(cfg)
    model.attn_impl = "reference"
    pspecs = model.param_specs()
    args = argument_bytes(cfg, shape, mesh, batch=b, seq=s, model=model)
    arg_total = sum(args.values())

    t0 = time.time()
    accum = 1
    if traced(cfg, shape) and chips > 1:
        mem, full = _traced_cell(cfg, shape, mesh, b, s, model, args, rec)
        peak = mem.pop("peak_bytes_per_device")
    elif shape.kind == "train":
        accum = accum_steps_for(cfg, b, s, dp, mp)
        rec["accum_steps"] = accum
        b_mb = max(b_local // accum, 1)
        mb = registry.input_specs(cfg, shape, batch=b_mb, seq=s)
        grads = counter.trace(
            lambda p, m: accumulated_grads(model, p, m)[0], (pspecs, mb),
            scale=_grad_share(cfg, mesh, model, pspecs))
        # the update on the ZeRO-sharded state
        zspecs = sh.grad_specs_of(cfg, mesh, pspecs)
        shard = opt.tree_map(lambda p, z: torch.empty(
            _shard_shape(p.shape, z, mesh), dtype=p.dtype, device="meta"),
            pspecs, zspecs)
        ocfg = opt_config_for(cfg)
        sstate = opt.opt_state_specs(ocfg, shard)
        update = counter.trace(
            lambda p, g, st: opt.adamw_update(ocfg, p, g, st)[:2],
            (shard, shard, sstate))
        acc = sharded_bytes(pspecs, zspecs, mesh)     # grads at ZeRO layout
        outputs = args["params"] + args["opt_state"]
        phase_mb = (acc if accum > 1 else 0) + grads.peak
        phase_u = acc + update.peak
        mem = {"argument_size_in_bytes": arg_total,
               "output_size_in_bytes": outputs,
               "temp_size_in_bytes": int(max(phase_mb,
                                             phase_u - outputs)),
               "alias_size_in_bytes": 0}
        peak = arg_total + max(phase_mb, phase_u)
        full = {"flops": accum * grads.flops / mp + update.flops,
                "bytes": accum * grads.bytes / mp + update.bytes}
        act_b, act_s = b_mb, s
    else:
        bspecs = registry.input_specs(cfg, shape, batch=b_local, seq=s)
        fwd = counter.trace(registry.step_fn(cfg, shape, model),
                            (pspecs, bspecs))
        logits = fwd.out[0] if shape.kind == "decode" else fwd.out
        cache = (sharded_bytes(bspecs["cache"], sh.batch_specs_of(
            cfg, mesh, {"cache": bspecs["cache"]})["cache"], mesh)
            if shape.kind == "decode" else 0)
        new_out = logits.numel() * logits.element_size()
        mem = {"argument_size_in_bytes": arg_total,
               "output_size_in_bytes": new_out + cache,
               "temp_size_in_bytes": int(max(fwd.peak - new_out, 0)),
               "alias_size_in_bytes": cache}   # written in place
        peak = arg_total + fwd.peak
        full = _part(fwd, mp)
        act_b, act_s = b_local, (1 if shape.kind == "decode" else s)
    mem["generated_code_size_in_bytes"] = 0
    mem["total_bytes_per_device"] = (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    mem["peak_bytes_per_device"] = int(peak)
    mem["arguments"] = args
    if "partition" not in full:
        full["collectives"] = collectives(cfg, mesh, model, pspecs,
                                          shape.kind, accum, act_b, act_s)
        full["n_collectives"] = sum(c["count"] for c in full["collectives"])
        full["partition"] = "modelled" if mp > 1 else "exact"
    rec["lower_compile_s"] = time.time() - t0      # the trace's seconds

    frag_parts = []
    # a traced step runs every loop trip; its fragments are the modelled
    # record's, which a traced cell has no use for
    for frag in ([] if full["partition"] == "traced"
                 else model.fragments(shape.kind, act_b, s)):
        if shape.kind == "train":
            c = counter.trace(_grad_wrap(frag.fn), frag.args, grad=True)
        else:
            c = counter.trace(frag.fn, frag.args)
        frag_parts.append(dict(_part(c, mp), collectives=[],
                               n_collectives=0, name=frag.name,
                               mult=frag.extra_trips * accum))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] trace "
              f"{rec['lower_compile_s']:.1f}s  mem/device "
              f"{mem['total_bytes_per_device'] / 2**30:.2f} GiB "
              f"flops/device {full['flops']:.3e} "
              f"colls {full['n_collectives']} ({full['partition']})",
              flush=True)
    rec.update(status="OK", chips=chips, memory=mem, full=full,
               fragments=frag_parts, trips_in_full=True)
    return rec


def roofline_record(rec: dict) -> dict | None:
    """Roofline terms of an OK record: its full part alone (every loop
    trip is in it), each collective counted ``count`` times."""
    if rec.get("status") != "OK":
        return None
    full = rec["full"]
    ops = [analyze.CollectiveOp(**{k: v for k, v in c.items()
                                   if k != "mesh_dims"} | {"count": 1})
           for c in full["collectives"] for _ in range(c["count"])]
    part = {"flops": full["flops"], "bytes": full["bytes"],
            "collectives": ops, "mult": 1}
    return analyze.terms_from_parts([part], rec["chips"]).as_dict()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(registry.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = f"{arch}__{shape}__{'multi' if mp else 'single'}.json"
                path = outdir / name
                if path.exists() and not args.force:
                    old = json.loads(path.read_text())
                    print(f"[cached] {name}: {old.get('status')}")
                    n_ok += old.get("status") == "OK"
                    n_skip += old.get("status") == "SKIP"
                    n_fail += old.get("status") == "FAIL"
                    continue
                try:
                    rec = run_cell(arch, shape, mp)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "FAIL", "error": str(e)[:2000]}
                rl = roofline_record(rec)
                if rl:
                    rec["roofline"] = rl
                    print(f"  roofline: compute {rl['t_compute']:.4f}s "
                          f"memory {rl['t_memory']:.4f}s "
                          f"collective {rl['t_collective']:.4f}s "
                          f"-> {rl['bottleneck']}-bound", flush=True)
                path.write_text(json.dumps(rec, indent=1, default=float))
                n_ok += rec["status"] == "OK"
                n_skip += rec["status"] == "SKIP"
                n_fail += rec["status"] == "FAIL"
    print(f"\nDRY-RUN SUMMARY: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
