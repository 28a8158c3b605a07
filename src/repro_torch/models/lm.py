"""Causal LM assembly (port of ``repro.models.lm``: ``init``, ``embed``,
``hidden``, ``logits``, ``loss`` with DeepSeek's MTP head, ``prefill``, and
decode: ``cache_capacity``, ``init_cache``, ``decode_step``) for the dense,
MoE (granite, deepseek with MLA), VLM (qwen2-vl: M-RoPE and the vision
stub's patch embeddings), hybrid (hymba: attention and a Mamba head in
every layer) and SSM (xlstm: mLSTM layers with sLSTM at
``xlstm.slstm_at``) families. The encoder-decoder family (whisper) is
``models.whisper.EncDecLM``, which ``registry.make_model`` builds; ``LM``
refuses it. ``param_specs`` and the roofline ``fragments`` serve the
dry-run (``launch/dryrun.py``).

On DTensor params and batches (``sharding/specs.py`` places them) every
family runs sharded, as GSPMD runs the reference's jitted steps: the
full-sequence forward, the loss (with the MTP head), ``prefill`` and
``decode_step``. The embedding lookup and the head are vocab parallel,
attention and the MLP tensor parallel, MoE expert parallel
(``models/moe.py``), Mamba, the mLSTM and the sLSTM parallel over their
channels or heads (``models/ssm.py``), and ``act_spec`` (the reference's
hook, set by the launcher under ``seq_shard_activations`` for train and
prefill) is the residual stream's layout, which ``_constrain`` applies
before and after each layer body; the VLM's stub patches join the stream
before it (``embed``), and its M-RoPE positions, made here or the
batch's own, are split over the batch as the tokens are. Without
``act_spec`` ``_constrain`` only reduces pending partial sums (the
embedding's), so the stream is batch-sharded and whole on the model axis;
a decode step's stream always is. The decode cache is made shard by shard
(``init_cache(shardings=...)``) in the reference's ``cache_leaf_sharding``
layouts, attention decodes over each rank's own slots, merging the
softmax where the capacity is split (``models/attention.py``), and the
recurrent states are updated on each rank's own channels or heads. The
encoder-decoder family is ``models/whisper.py``'s, sharded alike.
``cfg.remat`` is honoured as the reference's ``_remat``: while autograd
records a layer of a stacked group (4 or more layers), it is
rematerialised in the backward (``torch.utils.checkpoint``, with a
selective policy for ``"dots"`` and ``"names"``); a forward that records
nothing runs as before.

The param tree is the reference's: ``{"embed", "final_norm", "groups"}``
(+ ``"head"`` when embeddings are untied, + ``"mtp"`` under MTP), where
each group of 4 or more layers is one dict of tensors stacked on axis 0
and a shorter group is a list of per-layer dicts, so reference params map
onto it 1:1. The decode cache is grouped the same way (``init_cache``),
written in place; ``position`` is an int or a 0-d tensor on the device. A
layer's cache is its K/V (``attention.init_cache``), ``{"attn", "ssm"}``
for a hybrid layer (K/V and the Mamba state), or the mLSTM's or sLSTM's
recurrent state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve
from repro_torch.models import attention, blocks, layers, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.sharding import dtensor as dtn


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str                  # blocks.layer_params kind
    indices: tuple[int, ...]   # absolute layer ids
    scanned: bool              # stacked on axis 0 (>= 4 layers)

    @property
    def size(self) -> int:
        return len(self.indices)


@dataclasses.dataclass(frozen=True)
class Fragment:
    """A loop body for the roofline combiner: the enclosed fn runs
    ``extra_trips`` more times in the step than once (the reference counts
    scan bodies once in its compiled step; eager PyTorch runs and counts
    every trip, so the dry-run records fragments but combines the full
    step alone).

    ``arg_kinds`` aligns with ``args``: "params" (the param layout
    rules), "cache" (cache/state rules), or a trailing-dims tail tuple for
    ``sharding/specs._fit`` (e.g. ("data", None, "model", None))."""

    name: str
    fn: Callable
    args: tuple
    extra_trips: int
    arg_kinds: tuple = ()


def make_groups(cfg: ModelConfig) -> list[LayerGroup]:
    """Split layers into uniform-kind groups; stack groups of >= 4 layers.
    An MoE model's first ``first_k_dense`` layers are ``moe_dense``, the
    rest ``moe``; the hybrid family's layers are ``hybrid``; the SSM
    family's are ``slstm`` at ``xlstm.slstm_at``, else ``mlstm``; the dense
    and VLM families are ``dense``."""
    if cfg.enc_dec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder config: build it with "
            "registry.make_model, which gives models.whisper.EncDecLM")

    def kind(i: int) -> str:
        if cfg.family == "moe":
            return "moe_dense" if i < cfg.moe.first_k_dense else "moe"
        if cfg.family == "hybrid":
            return "hybrid"
        if cfg.family == "ssm":
            return "slstm" if i in cfg.xlstm.slstm_at else "mlstm"
        return "dense"
    kinds = [kind(i) for i in range(cfg.num_layers)]
    groups: list[LayerGroup] = []
    start = 0
    for i in range(1, cfg.num_layers + 1):
        if i == cfg.num_layers or kinds[i] != kinds[start]:
            idx = tuple(range(start, i))
            groups.append(LayerGroup(kinds[start], idx, len(idx) >= 4))
            start = i
    return groups


# ATen's products with no batch dims: what ``jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable`` keeps (a batched einsum runs as bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# the reference's ``checkpoint_name`` tags that ``remat="names"`` keeps
_NAMES = ("qkv", "mlp_pre_up", "mlp_pre_gate")


def _remat_policy(cfg: ModelConfig):
    """The selective-checkpoint policy of ``cfg.remat``: ``"dots"`` saves
    every product with no batch dims, ``"names"`` the products computed
    under the tags of ``_NAMES`` (``layers.checkpoint_name``); the rest is
    recomputed in the backward."""
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, func, *args, **kwargs):
        keep = func in _DOTS and (
            cfg.remat == "dots"
            or layers.current_checkpoint_name() in _NAMES)
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _remat(cfg: ModelConfig, fn):
    """The reference's ``_remat`` (``jax.checkpoint`` of a stacked group's
    scan body) for one layer's forward: ``"full"`` keeps only the layer's
    inputs, ``"dots"`` and ``"names"`` also the products ``_remat_policy``
    saves, ``"none"`` is a plain call. ``hidden`` applies it only while
    autograd records the layer."""
    if cfg.remat not in ("none", "full", "dots", "names"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _remat_policy(cfg))
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _add_aux(total, aux):
    """``total + aux``; on DTensors a plain (dense layer's zero) term is
    skipped, and the first DTensor term replaces the plain zero start."""
    if dtn.is_dt(aux):
        return aux if not dtn.is_dt(total) else total + aux
    return total if dtn.is_dt(total) else total + aux


def layer_params_of(gp, l: int) -> Params:
    """Layer ``l`` of a group's params (stacked dict or per-layer list)."""
    if isinstance(gp, list):
        return gp[l]
    return {k: (layer_params_of(v, l) if isinstance(v, dict) else v[l])
            for k, v in gp.items()}


def _stack(trees: list[Params]) -> Params:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in trees[0]}


class LM:
    #: optional spec tuple for residual-stream activations [B, S, d]
    #: (``sharding/specs.act_spec_of``: batch over the data axes, sequence
    #: over model), set by the launcher; None keeps the batch layout
    act_spec = None

    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        self.cfg = cfg
        self.groups = make_groups(cfg)
        self.windows = np.asarray(cfg.window_array(), np.int32)
        # full_attention's impl for every layer: None takes the CUDA flash
        # kernel on a card and the chunked path on the CPU; "reference"
        # forces the chunked path (chip_smoke.py compares the two), and is
        # the one that trains on a card: the kernel has no backward
        self.attn_impl: str | None = None
        self._param_specs = None

    def _constrain(self, x):
        """The residual stream in ``act_spec``'s layout (a no-op on plain
        tensors); without ``act_spec``, pending partial sums reduced."""
        if not dtn.is_dt(x):
            return x
        if self.act_spec is None:
            return dtn.resolved(x)
        from repro_torch.sharding.specs import placements
        return dtn.settle(x, placements(x.device_mesh, self.act_spec))

    # -- parameters ----------------------------------------------------------

    def init(self, gen: torch.Generator, *, device="cuda") -> Params:
        """Random params from ``gen`` (seeded by the caller), placed on
        ``device``. Draws happen on the generator's device."""
        cfg = self.cfg
        dev = resolve(device)
        dt = dtype_of(cfg.param_dtype)
        params: Params = {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       dev),
            "final_norm": layers.norm_params(cfg, cfg.d_model, dev),
            "groups": [],
        }
        for g in self.groups:
            per = [blocks.layer_params(gen, cfg, g.kind, dev)
                   for _ in g.indices]
            params["groups"].append(_stack(per) if g.scanned else per)
        if not cfg.tie_embeddings:
            params["head"] = layers.dense_init(gen, cfg.d_model,
                                               cfg.vocab_size, dt, dev)
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": layers.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                          dt, dev),
                "layer": blocks.layer_params(gen, cfg, self._mtp_kind(), dev),
                "norm_h": layers.norm_params(cfg, cfg.d_model, dev),
                "norm_e": layers.norm_params(cfg, cfg.d_model, dev),
            }
        return params

    def param_specs(self) -> Params:
        """The param tree of ``init`` as ``meta`` tensors (shapes and
        dtypes; nothing is drawn or allocated at any width), made once a
        model."""
        if self._param_specs is None:
            self._param_specs = self.init(torch.Generator(), device="meta")
        return self._param_specs

    def _mtp_kind(self) -> str:
        return "moe_dense" if self.cfg.family == "moe" else "dense"

    # -- embedding -------------------------------------------------------------

    def embed(self, params: Params, batch: dict):
        """Token embeddings [B,S,d]; under the vision stub a batch's
        ``patch_embeds`` [B,P,d] come first ([B,P+S,d]). On DTensors the
        vocab-parallel lookup's partial sums are reduced before the
        concatenation, which runs in the batch's layout; the stream takes
        ``act_spec``'s after it (``hidden``'s first ``_constrain``)."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        x = layers.embed_lookup(params["embed"], batch["tokens"]).to(cdt)
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(cdt), dtn.resolved(x)],
                          dim=1)
        if cfg.embed_scale:
            x = x * np.sqrt(cfg.d_model)
        return x

    def _positions(self, batch: dict, seq: int, batchsz: int):
        """[B, S] int32 positions 0..S-1; under M-RoPE [3, B, S], the
        batch's own ``positions`` if it brings them. The flash branch masks
        by sequence index, so it refuses caller-given M-RoPE positions. On
        DTensor tokens the positions made here are each rank's rows, placed
        like the tokens' (``[3, B, S]`` with the batch on dim 1); a batch's
        own are in its layout already (``batch_shardings``)."""
        tokens = batch["tokens"]
        if self.cfg.mrope and "positions" in batch:
            if attention.takes_flash(self.attn_impl, tokens):
                raise NotImplementedError(
                    f"{self.cfg.name}: the flash branch masks by sequence "
                    "index and cannot honour a batch's own M-RoPE "
                    "positions; set attn_impl='reference' to attend at "
                    "those positions")
            return batch["positions"]
        if dtn.is_dt(tokens):
            pl = tokens.placements
            return dtn.on_shards(
                lambda t: self._positions({"tokens": t}, seq, t.shape[0]),
                dtn.remap(pl, {0: 1}) if self.cfg.mrope else pl, tokens)
        p = torch.arange(seq, dtype=torch.int32, device=tokens.device)
        if not self.cfg.mrope:
            return p.expand(batchsz, seq)
        return p.expand(3, batchsz, seq)

    # -- full-sequence forward ---------------------------------------------------

    def hidden(self, params: Params, x, positions, want_cache: bool = False):
        """Returns (h, aux, caches): caches[g] is {"k","v"} stacked
        [L,B,S,nkv,hd] for a stacked group, else a list of per-layer
        dicts — the reference's layout; an xLSTM layer has no cache entry
        (None, or a list of them)."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for g, gp in zip(self.groups, params["groups"]):
            # a stacked group's layers are rematerialised (the reference
            # checkpoints its scan body), a shorter group's are not
            fwd = _remat(cfg, self._layer) \
                if g.scanned and layers.records_grad(x, gp) \
                else self._layer
            group_cache = []
            for j, li in enumerate(g.indices):
                x, aux, cache = fwd(
                    g.kind, layer_params_of(gp, j), x, positions,
                    int(self.windows[li]), want_cache)
                # a dense layer's aux is a plain zero: on DTensors only the
                # MoE layers' (pending sums over the data axes) are added
                aux_total = _add_aux(aux_total, aux)
                group_cache.append(cache)
            if want_cache and g.scanned:
                caches.append(None if group_cache[0] is None else
                              {n: torch.stack([c[n] for c in group_cache])
                               for n in group_cache[0]})
            else:
                caches.append(group_cache)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return x, aux_total, (caches if want_cache else None)

    def _layer(self, kind, p, x, positions, window, want_cache=False):
        """One layer body with the stream's layout constraint on both
        sides (the reference's scan body)."""
        x, aux, cache = blocks.layer_fwd(
            self.cfg, kind, p, self._constrain(x), positions, window,
            want_cache, self.attn_impl)
        return self._constrain(x), aux, cache

    def head_matrix(self, params: Params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])

    def logits(self, params: Params, h):
        cdt = dtype_of(self.cfg.compute_dtype)
        return h.to(cdt) @ self.head_matrix(params).to(cdt)

    # -- losses and prefill ----------------------------------------------------------

    def loss(self, params: Params, batch: dict):
        """Mean next-token cross-entropy over ``batch["tokens"]`` [B,S] on
        the text region (stub patches are not predicted; fused head + CE,
        no [B,S,V] logits), plus the layers' aux loss, plus 0.3 times the
        MTP loss under MTP. Returns (total, {"ce", "aux"[, "mtp_ce"]})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self.embed(params, batch)
        s = x.shape[1]
        positions = self._positions(batch, s, x.shape[0])
        h, aux, _ = self.hidden(params, x, positions)
        h = dtn.whole_on(h)                # the head takes whole sequences
        vis = s - tokens.shape[1]
        ce = layers.softmax_xent_fused(h[:, vis:-1, :],
                                       self.head_matrix(params),
                                       tokens[:, 1:])
        ce, aux = dtn.resolved(ce), dtn.resolved(aux)
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp_ce = self._mtp_loss(params, h[:, vis:], tokens, positions)
            metrics["mtp_ce"] = mtp_ce
            total = total + 0.3 * mtp_ce
        return total, metrics

    def _mtp_loss(self, params: Params, h, tokens, positions):
        """DeepSeek-V3 multi-token prediction (depth 1): one extra layer
        predicts t+2 from [h_t ; embed(token_{t+1})]. On DTensors ``h`` is
        whole on the model axis; the embedding is looked up vocab parallel
        and the projection's output brought back to ``h``'s layout, so the
        layer runs on the stream's layout (the reference constrains
        nothing here)."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        p = params["mtp"]
        h_in = layers.apply_norm(cfg, p["norm_h"], h[:, :-1])
        emb = dtn.resolved(layers.embed_lookup(params["embed"],
                                               tokens[:, 1:]))
        e_in = layers.apply_norm(cfg, p["norm_e"], emb.to(cdt))
        x = torch.cat([h_in, e_in], dim=-1) @ p["proj"].to(cdt)
        if dtn.is_dt(x):
            x = dtn.settle(x, h_in.placements)
        x, _, _ = blocks.layer_fwd(cfg, self._mtp_kind(), p["layer"], x,
                                   positions[..., :-1], 0,
                                   attn_impl=self.attn_impl)
        return layers.softmax_xent_fused(x[:, :-1, :],
                                         self.head_matrix(params),
                                         tokens[:, 2:])

    def prefill(self, params: Params, batch: dict):
        """Full-sequence forward; returns the last token's logits
        [B,1,V]. On DTensors the stream is in ``act_spec``'s layout
        between layers; the last token is taken from the rank that holds
        it (``dtensor.last_along``) and the head is vocab parallel, so the
        logits are split over the model axis."""
        x = self.embed(params, batch)
        positions = self._positions(batch, x.shape[1], x.shape[0])
        h, _, _ = self.hidden(params, x, positions)
        return self.logits(params, dtn.resolved(dtn.last_along(h, 1)))

    # -- decode ----------------------------------------------------------------

    def cache_capacity(self, layer_idx: int, max_len: int) -> int:
        w = self.cfg.layer_window(layer_idx)
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int, *, device="cuda",
                   shardings=None):
        """Decode cache grouped like ``params["groups"]``: one dict with a
        leading layer axis for a stacked group, else a list of per-layer
        dicts (``attention.init_cache``: K/V, or MLA's latent
        ``{"ckv", "kpe", "pos"}``; a hybrid layer's ``{"attn", "ssm"}``,
        its K/V and ``ssm.mamba_init_state``; an mLSTM's or sLSTM's state).
        A group's capacity is the largest of its layers', so a group that
        mixes windowed and global layers holds ``max_len`` slots and
        applies the window through the mask; only an all-windowed group is
        a ring buffer of ``window`` slots.

        With ``shardings`` (``sharding/specs.batch_shardings`` of this
        cache: ``(mesh, placements)`` pairs in its structure) the leaves
        are DTensors and each rank makes only its own shard, on the
        mesh's device: no rank allocates a whole leaf. Each leaf starts
        as on one device: positions at -1 (empty), an mLSTM's or sLSTM's
        ``m`` at ``ssm.M_START``, everything else at zero."""
        if shardings is not None:
            from repro_torch.sharding import specs

            def start(path):
                name = specs._leaf_name(path)
                if name == "pos":
                    return -1
                kind = self.groups[path[0]].kind
                return ssm.M_START[kind] if name == "m" else 0
            return specs.full_leaves(
                self.init_cache(batch, max_len, device="meta"), shardings,
                start)
        dev = resolve(device)
        out = []
        for g in self.groups:
            cap = max(self.cache_capacity(i, max_len) for i in g.indices)
            if g.scanned:
                out.append(self._cache_one(g.kind, batch, cap,
                                           (len(g.indices),), device=dev))
            else:
                out.append([self._cache_one(g.kind, batch, cap, (),
                                            device=dev)
                            for _ in g.indices])
        return out

    def _cache_one(self, kind: str, batch: int, cap: int, axes=(), *,
                   device) -> Params:
        """One layer's cache entry (with leading ``axes``) of a ``kind``
        layer."""
        cfg = self.cfg
        if kind == "hybrid":
            return {"attn": attention.init_cache(cfg, batch, cap, axes,
                                                 device=device),
                    "ssm": ssm.mamba_init_state(cfg, batch, axes,
                                                device=device)}
        if kind == "mlstm":
            return ssm.mlstm_init_state(cfg, batch, axes, device=device)
        if kind == "slstm":
            return ssm.slstm_init_state(cfg, batch, axes, device=device)
        return attention.init_cache(cfg, batch, cap, axes, device=device)

    def decode_step(self, params: Params, cache, tokens, position):
        """tokens [B,1] at ``position`` (a Python int, a 0-d int tensor on
        the cache's device, or a replicated 0-d DTensor) -> (logits
        [B,1,V], cache). The cache is written in place and returned.

        On DTensor params, cache and tokens (``sharding/specs.py``'s
        layouts: the cache's are ``cache_leaf_spec``'s) the step runs
        sharded, as GSPMD runs the reference's donated-cache step: the
        stream is batch-sharded and whole on the model axis (``act_spec``
        does not apply to one token), each layer's cache is written on the
        ranks that own the slot and attended on each rank's own slots
        (``models/attention.py``), and the logits come back split over the
        model axis (the vocab-parallel head)."""
        cfg = self.cfg
        x = dtn.resolved(self.embed(params, {"tokens": tokens}))
        # one tensor for every layer (a no-op for a tensor already there)
        position = attention.as_position(position, x)
        for g, gp, gc in zip(self.groups, params["groups"], cache):
            for j, li in enumerate(g.indices):
                x, _ = blocks.layer_decode(
                    cfg, g.kind, layer_params_of(gp, j), x,
                    layer_params_of(gc, j), position, int(self.windows[li]))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return self.logits(params, x), cache

    # -- roofline fragments ----------------------------------------------------

    def fragments(self, mode: str, batch: int, seq: int) -> list[Fragment]:
        """The reference's loop bodies with their trip counts: stacked
        layer bodies, attention query-chunk bodies, SSM chunk bodies and
        sLSTM cells, their args as ``meta`` tensors. mode: train | prefill
        | decode. The fns are the port's own functions."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        f32, i32 = torch.float32, torch.int32
        frags: list[Fragment] = []
        pspecs = self.param_specs()

        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        pos = sds((3, batch, seq) if cfg.mrope else (batch, seq), i32)
        x_spec = sds((batch, seq, cfg.d_model), cdt)
        dp = "data"

        for gi, g in enumerate(self.groups):
            gp = pspecs["groups"][gi]
            p1 = layer_params_of(gp, 0)     # one layer's specs
            if mode in ("train", "prefill") and g.scanned:
                def fwd(p_l, x, positions, _kind=g.kind):
                    # the real scan body's layout constraints
                    y, aux, _ = blocks.layer_fwd(cfg, _kind, p_l,
                                                 self._constrain(x),
                                                 positions, 0,
                                                 attn_impl="reference")
                    return self._constrain(y), aux
                frags.append(Fragment(
                    f"layer_{g.kind}", _remat(cfg, fwd), (p1, x_spec, pos),
                    g.size - 1,
                    ("params", (dp, None, None),
                     (None, dp, None) if cfg.mrope else (dp, None))))
            if mode == "decode" and g.scanned:
                cap = max(self.cache_capacity(i, seq) for i in g.indices)
                cache1 = self._cache_one(g.kind, batch, cap, device="meta")
                x1 = sds((batch, 1, cfg.d_model), cdt)

                def dec(p_l, x, c_l, _kind=g.kind):
                    return blocks.layer_decode(cfg, _kind, p_l, x, c_l, 0, 0)
                frags.append(Fragment(f"decode_{g.kind}", dec,
                                      (p1, x1, cache1), g.size - 1,
                                      ("params", (dp, None, None), "cache")))

        if mode not in ("train", "prefill"):
            return frags

        # ---- attention q-chunk bodies (inside every attn layer) ----------
        nc = attention.attn_q_chunks(seq)
        n_attn = sum(1 for g in self.groups
                     if g.kind in ("dense", "moe", "moe_dense", "hybrid")
                     for _ in g.indices)
        if nc > attention.CHUNK_SCAN_THRESHOLD and n_attn:
            chunk = -(-seq // nc)
            nq, hd = cfg.num_heads, cfg.head_dim_
            if cfg.mla:
                m = cfg.mla
                qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                qc = sds((batch, chunk, nq, qd), cdt)
                kf = sds((batch, seq, nq, qd), cdt)
                vf = sds((batch, seq, nq, m.v_head_dim), cdt)
            else:
                qc = sds((batch, chunk, nq, hd), cdt)
                kf = sds((batch, seq, nq, hd), cdt)
                vf = sds((batch, seq, nq, hd), cdt)
            pc = sds((batch, chunk), i32)
            kp = sds((batch, seq), i32)

            def attn_chunk(q, p_q, k, v, p_k):
                bias = attention._window_bias(p_q, p_k, 0, True)
                return attention._mha_one_chunk(q, k, v, bias, cdt)
            head_tail = (dp, None, "model", None) if nq % 16 == 0 \
                else (dp, None, None, None)
            frags.append(Fragment(
                "attn_chunk", _remat(cfg, attn_chunk), (qc, pc, kf, vf, kp),
                (nc - 1) * n_attn,
                (head_tail, (dp, None), head_tail, head_tail, (dp, None))))

        # ---- mamba chunk bodies -------------------------------------------
        if cfg.ssm is not None:
            nc_s = -(-seq // ssm.SSM_CHUNK)
            n_ssm = cfg.num_layers
            if nc_s > 1 and n_ssm:
                inner = cfg.ssm.expand * cfg.d_model
                pm = {"a_log": sds((inner, cfg.ssm.state_dim),
                                   dtype_of(cfg.param_dtype))}
                h0 = sds((batch, inner, cfg.ssm.state_dim), f32)
                c = min(ssm.SSM_CHUNK, seq)
                dtc = sds((batch, c, inner), cdt)
                bc = sds((batch, c, cfg.ssm.state_dim), cdt)
                frags.append(Fragment(
                    "mamba_chunk", _remat(cfg, ssm.mamba_chunk_body),
                    (pm, h0, dtc, dtc, bc, bc), (nc_s - 1) * n_ssm,
                    ("params", (dp, "model", None), (dp, None, "model"),
                     (dp, None, "model"), (dp, None, None),
                     (dp, None, None))))

        # ---- mLSTM chunk bodies -------------------------------------------
        if cfg.xlstm is not None:
            n_m = len([i for i in range(cfg.num_layers)
                       if i not in cfg.xlstm.slstm_at])
            nc_m = -(-seq // ssm.MLSTM_CHUNK)
            if nc_m > 1 and n_m:
                nh, hd = cfg.num_heads, cfg.head_dim_
                c = min(ssm.MLSTM_CHUNK, seq)
                carry = (sds((batch, nh, hd, hd), f32),
                         sds((batch, nh, hd), f32), sds((batch, nh), f32))
                qkv = sds((batch, c, nh, hd), cdt)
                gate = sds((batch, c, nh), f32)
                frags.append(Fragment(
                    "mlstm_chunk", _remat(cfg, ssm.mlstm_chunk_body),
                    (carry, qkv, qkv, qkv, gate, gate), (nc_m - 1) * n_m,
                    ("cache", (dp, None, None, None), (dp, None, None, None),
                     (dp, None, None, None), (dp, None, None),
                     (dp, None, None))))

        # ---- sLSTM sequential cells ----------------------------------------
        if cfg.xlstm is not None:
            n_slstm = len([i for i in range(cfg.num_layers)
                           if i in cfg.xlstm.slstm_at])
            if n_slstm and seq > 1:
                nh, hd = cfg.num_heads, cfg.head_dim_
                pl = ssm.slstm_params(torch.Generator(), cfg, "meta")
                carry = tuple(sds((batch, nh, hd), f32) for _ in range(4))
                xg = sds((batch, 4, nh, hd), cdt)
                frags.append(Fragment(
                    "slstm_cell", ssm.slstm_cell, (pl, carry, xg),
                    (seq - 1) * n_slstm,
                    ("params", "cache", (dp, None, None, None))))
        return frags


