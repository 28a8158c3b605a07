"""Causal LM assembly for the dense family (port of ``repro.models.lm``:
``init``, ``embed``, ``hidden``, ``logits``, ``loss``, ``prefill``, and
dense decode: ``cache_capacity``, ``init_cache``, ``decode_step``).

The param tree is the reference's: ``{"embed", "final_norm", "groups"}``
(+ ``"head"`` when embeddings are untied), where each group of 4 or more
layers is one dict of tensors stacked on axis 0 and a shorter group is a
list of per-layer dicts, so reference params map onto it 1:1. The decode
cache is grouped the same way (``init_cache``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve
from repro_torch.models import attention, blocks, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str                  # blocks.layer_params kind
    indices: tuple[int, ...]   # absolute layer ids
    scanned: bool              # stacked on axis 0 (>= 4 layers)


def make_groups(cfg: ModelConfig) -> list[LayerGroup]:
    """Split layers into uniform-kind groups; stack groups of >= 4 layers.
    Only the plain dense family is ported."""
    if cfg.family != "dense" or cfg.mla or cfg.mrope or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} (MLA, M-RoPE and MTP "
            "included) is not ported yet (ROADMAP queue 1 item 9)")
    idx = tuple(range(cfg.num_layers))
    return [LayerGroup("dense", idx, len(idx) >= 4)]


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
        return params

    # -- embedding -------------------------------------------------------------

    def embed(self, params: Params, batch: dict):
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        x = params["embed"][batch["tokens"]].to(cdt)
        if cfg.embed_scale:
            x = x * np.sqrt(cfg.d_model)
        return x

    def _positions(self, batch: dict, seq: int, batchsz: int):
        """[B, S] int32 positions 0..S-1 (M-RoPE is not ported)."""
        dev = batch["tokens"].device
        return torch.arange(seq, dtype=torch.int32, device=dev).expand(
            batchsz, seq)

    # -- full-sequence forward ---------------------------------------------------

    def hidden(self, params: Params, x, positions, want_cache: bool = False):
        """Returns (h, aux, caches): caches[g] is {"k","v"} stacked
        [L,B,S,nkv,hd] for a stacked group, else a list of per-layer
        dicts — the reference's layout."""
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for g, gp in zip(self.groups, params["groups"]):
            group_cache = []
            for j, li in enumerate(g.indices):
                x, aux, cache = blocks.layer_fwd(
                    cfg, g.kind, layer_params_of(gp, j), x, positions,
                    int(self.windows[li]), want_cache, self.attn_impl)
                aux_total = aux_total + aux
                group_cache.append(cache)
            if want_cache and g.scanned:
                caches.append({n: torch.stack([c[n] for c in group_cache])
                               for n in ("k", "v")})
            else:
                caches.append(group_cache)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return x, aux_total, (caches if want_cache else None)

    def head_matrix(self, params: Params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])

    def logits(self, params: Params, h):
        cdt = dtype_of(self.cfg.compute_dtype)
        return h.to(cdt) @ self.head_matrix(params).to(cdt)

    # -- losses and prefill ----------------------------------------------------------

    def loss(self, params: Params, batch: dict):
        """Mean next-token cross-entropy over ``batch["tokens"]`` [B,S]
        (fused head + CE, no [B,S,V] logits), plus the layers' aux loss.
        Returns (total, {"ce", "aux"})."""
        tokens = batch["tokens"]
        x = self.embed(params, batch)
        positions = self._positions(batch, x.shape[1], x.shape[0])
        h, aux, _ = self.hidden(params, x, positions)
        ce = layers.softmax_xent_fused(h[:, :-1, :], self.head_matrix(params),
                                       tokens[:, 1:])
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params: Params, batch: dict):
        """Full-sequence forward; returns the last token's logits
        [B,1,V]."""
        x = self.embed(params, batch)
        positions = self._positions(batch, x.shape[1], x.shape[0])
        h, _, _ = self.hidden(params, x, positions)
        return self.logits(params, h[:, -1:, :])

    # -- decode ----------------------------------------------------------------

    def cache_capacity(self, layer_idx: int, max_len: int) -> int:
        w = self.cfg.layer_window(layer_idx)
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        """Decode cache grouped like ``params["groups"]``: one dict with a
        leading layer axis for a stacked group, else a list of per-layer
        dicts (``attention.init_cache``). A group's capacity is the largest
        of its layers', so a group that mixes windowed and global layers
        holds ``max_len`` slots and applies the window through the mask;
        only an all-windowed group is a ring buffer of ``window`` slots."""
        dev = resolve(device)
        out = []
        for g in self.groups:
            cap = max(self.cache_capacity(i, max_len) for i in g.indices)
            if g.scanned:
                out.append(attention.init_cache(
                    self.cfg, batch, cap, (len(g.indices),), device=dev))
            else:
                out.append([attention.init_cache(self.cfg, batch, cap,
                                                 device=dev)
                            for _ in g.indices])
        return out

    def decode_step(self, params: Params, cache, tokens, position):
        """tokens [B,1] at ``position`` (a Python int or a 0-d int tensor on
        the cache's device) -> (logits [B,1,V], cache). The cache is written
        in place and returned."""
        cfg = self.cfg
        x = self.embed(params, {"tokens": tokens})
        # one tensor for every layer (a no-op for a tensor already there)
        position = torch.as_tensor(position, dtype=torch.int32,
                                   device=x.device)
        for g, gp, gc in zip(self.groups, params["groups"], cache):
            for j, li in enumerate(g.indices):
                x, _ = blocks.layer_decode(
                    cfg, g.kind, layer_params_of(gp, j), x,
                    layer_params_of(gc, j), position, int(self.windows[li]))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return self.logits(params, x), cache
