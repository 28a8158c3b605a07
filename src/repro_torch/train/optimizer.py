"""AdamW from scratch, with optional 8-bit block-quantized moments and fp32
master params for bf16 models (port of ``repro.train.optimizer``).

State layout is a tree mirroring the params, with the reference's keys:
``{"step", "m", "v"[, "master"]}``, a quantized moment ``{"q", "scale"}``.
So a checkpoint of the port's state restores onto the reference's tree and
back (``checkpoint/ckpt.py``), and the ZeRO-1 specs of
``sharding/specs.py`` apply leaf by leaf. 8-bit moments (deepseek-671b:
bf16 params would not fit fp32 Adam in one pod, DESIGN.md §6) use
block-wise absmax scaling over trailing 256-element blocks.

``step`` is a 0-d int32 tensor on the params' device, and nothing here
reads a value back to the host: the schedule, clipping and bias
correction are device arithmetic. ``torch.round`` rounds half to even, as
``jnp.round`` does. The trees are nested dicts, lists and tuples of
tensors; ``tree_map`` and ``tree_leaves`` walk them in JAX's order (dict
keys sorted), which the train step, the trainer and the gradient
all-reduce share.

On DTensors (params, grads and state placed by ``sharding/specs.py``) the
update is ZeRO's, as GSPMD partitions the reference's: each leaf's grad,
param and master are brought to its moments' layout (a reduce-scatter of
the pending gradient sums; the param's shard is cut on the rank), the
elementwise work runs on the local shards, and the updated param is
all-gathered back into its own layout. The global norm is one all-reduce
per layout pattern of partial sums. int8 moments keep the sharding-aligned
``[*param_lead, nb, block]`` layout. Where that layout splits the block
dim (ZeRO's data axis lands on it in some of deepseek-v3's leaves), the
update first gathers ``q``'s blocks whole (``whole_blocks``: int8, a
quarter of the fp32 moment's bytes), so each block is quantized with its
own absmax over the whole block, as on one device, and the new ``q`` is
cut back into its layout on each rank. A moment in the flat layout (a
last dim that does not divide into blocks: deepseek's ``wkv_a``) is
gathered whole for the update.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import dtensor as dtn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_moments: bool = False    # int8 block-quantized m/v
    master_fp32: bool = True           # fp32 master copy for bf16 params
    block: int = 256
    warmup_steps: int = 100
    schedule: str = "cosine"           # constant | cosine
    total_steps: int = 10_000


# -- trees -------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (tensors), with the matching
    subtrees of ``rest``: the structure is ``tree``'s, so a quantized
    moment's ``{"q", "scale"}`` reaches ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


# -- 8-bit block quantization -------------------------------------------------

def _pad_to_block(x, block):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    return F.pad(flat, (0, pad)), pad


def _absmax_q8(blocks):
    """(int8 q, fp32 scale with the reduced dim kept) of ``blocks``
    [..., block]."""
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_q8(x, block: int):
    """Block-quantize along the LAST dim, preserving leading dims, so the
    int8 state inherits the parameter's sharding (``q`` [..., nb, block],
    ``scale`` [..., nb]). Falls back to flat blocks (``q`` [nb, block],
    ``scale`` [nb]) for tensors whose last dim doesn't divide."""
    if x.dim() >= 1 and x.shape[-1] % block == 0 and x.shape[-1] > 0:
        blocks = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
        q, scale = _absmax_q8(blocks)
        return {"q": q, "scale": scale[..., 0]}
    flat, _ = _pad_to_block(x, block)
    q, scale = _absmax_q8(flat.reshape(-1, block))
    return {"q": q, "scale": scale[:, 0]}


def _aligned(q, shape) -> bool:
    """Whether ``q`` has the sharding-aligned layout of a ``shape`` param
    (``[*shape[:-1], nb, block]``), not the flat one."""
    shape = tuple(shape)
    return (q.dim() == len(shape) + 1
            and tuple(q.shape[:len(shape) - 1]) == shape[:-1]
            and q.shape[-2] * q.shape[-1] == shape[-1])


def dequantize_q8(qs, shape):
    q, scale = qs["q"], qs["scale"]
    shape = tuple(shape)
    if _aligned(q, shape):            # sharding-aligned layout
        return (q.to(torch.float32) * scale[..., None]).reshape(shape)
    vals = q.to(torch.float32) * scale[:, None]
    return vals.reshape(-1)[:math.prod(shape)].reshape(shape)


# -- state -------------------------------------------------------------------

def init_opt_state(cfg: OptConfig, params, shardings=None) -> dict:
    """Zero moments (fp32, or int8 blocks), ``step`` 0 on the params'
    device, and an fp32 master copy when some param is not fp32 (unless
    ``master_fp32`` is off: the 671B layout). ``shardings`` (the state's
    ``sharding.specs.opt_shardings``) makes every leaf a DTensor created
    shard by shard, the master cut from the params' own shards."""
    if shardings is not None:
        return _init_sharded(cfg, params, shardings)
    def zeros_like_moment(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize_q8(z, cfg.block) if cfg.quantized_moments else z

    leaves = tree_leaves(params)
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        "m": tree_map(zeros_like_moment, params),
        "v": tree_map(zeros_like_moment, params),
    }
    if cfg.master_fp32 and any(p.dtype != torch.float32 for p in leaves):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _init_sharded(cfg: OptConfig, params, shardings) -> dict:
    from repro_torch.sharding import specs as sh
    meta = opt_state_specs(cfg, params)

    def zeros(shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)

    def moment(shape, dtype, device):
        # an int8 moment's scales are its only fp32 leaves: a zero block's
        # scale is 1, as ``quantize_q8`` gives it
        if cfg.quantized_moments and dtype == torch.float32:
            return torch.ones(shape, dtype=dtype, device=device)
        return zeros(shape, dtype, device)
    state = {"step": sh.make_leaves(meta["step"], shardings["step"], zeros),
             "m": sh.make_leaves(meta["m"], shardings["m"], moment),
             "v": sh.make_leaves(meta["v"], shardings["v"], moment)}
    if "master" in meta:
        state["master"] = sh.map_pairs(
            lambda p, mesh, pl: dtn.settle(p.detach().to(torch.float32,
                                                         copy=True), pl),
            params, shardings["master"])
    return state


def opt_state_specs(cfg: OptConfig, param_specs) -> dict:
    """The state tree of ``init_opt_state`` as tensors on the ``meta``
    device: shapes and dtypes, no storage. ``param_specs`` is a tree of
    tensors (any device, ``meta`` included) or of objects with ``shape``
    and ``dtype`` (a torch dtype)."""
    return init_opt_state(cfg, tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"),
        param_specs))


def _lr_at(cfg: OptConfig, step):
    """Warmup, then cosine (or constant) decay to a 0.1 floor, at the 0-d
    ``step`` tensor; an fp32 tensor on its device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * t))
    else:
        decay = 1.0
    return cfg.lr * warm * (0.1 + 0.9 * decay)


def _f32(x: float, like) -> torch.Tensor:
    """A Python float as a 0-d fp32 tensor beside ``like``: ``x / t``
    divides (torch's ``float / tensor`` multiplies by a reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def global_norm(tree):
    """The L2 norm of every leaf together. On DTensors each leaf's sum of
    squares is a partial sum over its sharded mesh dims; equal patterns
    are added on the rank and each is all-reduced once."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(tree)]
    if dtn.is_dt(sq[0]):
        return torch.sqrt(dtn.group_sum(sq))
    return torch.sqrt(sum(sq))


def whole_blocks(qs, shape) -> dict:
    """An int8 moment of a ``shape`` param with ``q``'s quantization blocks
    (its last dim) whole on every rank: gathered over the mesh dims that
    split them (a no-op where none does). A moment in the flat layout
    (the param's last dim does not divide into blocks) is gathered whole,
    ``scale`` too: its flat blocks do not follow the param's dims."""
    q = qs["q"]
    if not dtn.is_dt(q):
        return qs
    from torch.distributed.tensor import Replicate
    if not _aligned(q, shape):
        whole = [Replicate()] * q.device_mesh.ndim
        return {"q": dtn.settle(q, whole),
                "scale": dtn.settle(qs["scale"], whole)}
    last = q.ndim - 1
    return {"q": dtn.settle(q, [Replicate() if pl.is_shard(last) else pl
                                for pl in q.placements]),
            "scale": qs["scale"]}


def _to_work_layout(g, p, m, v, master):
    """The grad, moments, param and master of a leaf in its moments'
    layout (fp32 moments: theirs; int8: the dequantized moment's, its
    blocks whole) on DTensors: the grad's pending sums reduce-scattered,
    the others' shards cut on the rank; plain tensors as they are."""
    if not dtn.is_dt(p):
        return g, m, v, master
    if isinstance(m, dict):
        m, v = whole_blocks(m, p.shape), whole_blocks(v, p.shape)
        pl = dequantize_q8(m, p.shape).placements
    else:
        pl = m.placements
    return dtn.settle(g, pl), m, v, dtn.settle(master, pl)


def adamw_update(cfg: OptConfig, params, grads, state):
    """One AdamW step. Returns (new_params, new_state, metrics) with
    metrics ``{"grad_norm", "lr"}`` (0-d device tensors); the inputs are
    not written. On DTensors the results are in the inputs' layouts."""
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    masters = state.get("master", params)
    ms, vs = state["m"], state["v"]
    if dtn.any_dt(params):
        work = tree_map(_to_work_layout, grads, params, ms, vs, masters)
        grads, ms, vs, masters = (tree_map(lambda p, w, _i=i: w[_i], params,
                                           work) for i in range(4))
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0

    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v, master):
        g = g.to(torch.float32) * scale
        if cfg.quantized_moments:
            m_f = dequantize_q8(m, p.shape)
            v_f = dequantize_q8(v, p.shape)
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
        upd_ = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        master = master.to(torch.float32)
        master = master - lr * (upd_ + cfg.weight_decay * master)
        if cfg.quantized_moments:
            m_o, v_o = quantize_q8(m_f, cfg.block), quantize_q8(v_f,
                                                                cfg.block)
        else:
            m_o, v_o = m_f, v_f
        return master.to(p.dtype), m_o, v_o, master

    out = tree_map(upd, params, grads, ms, vs, masters)

    def part(i, like):
        # on DTensors, each result back in its input's layout (the param's
        # all-gather over the data axes)
        return tree_map(lambda p, t, l: tree_map(
            lambda x, y: dtn.settle(x, y.placements) if dtn.is_dt(y) else x,
            t[i], l), params, out, like)

    new_state = {"step": step, "m": part(1, state["m"]),
                 "v": part(2, state["v"])}
    if "master" in state:
        new_state["master"] = part(3, state["master"])
    return part(0, params), new_state, {"grad_norm": gnorm, "lr": lr}
