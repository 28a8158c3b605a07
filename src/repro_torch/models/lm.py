"""Causal LM assembly (port of ``repro.models.lm``: ``init``, ``embed``,
``hidden``, ``logits``, ``loss`` with DeepSeek's MTP head, ``prefill``, and
decode: ``cache_capacity``, ``init_cache``, ``decode_step``) for the dense,
MoE (granite, deepseek with MLA) and VLM (qwen2-vl: M-RoPE and the vision
stub's patch embeddings) families. The hybrid, SSM and encoder-decoder
families (hymba, xlstm, whisper) are not ported yet (ROADMAP queue 1 item
9c), nor the reference's roofline ``fragments`` and sharding hooks.

The param tree is the reference's: ``{"embed", "final_norm", "groups"}``
(+ ``"head"`` when embeddings are untied, + ``"mtp"`` under MTP), where
each group of 4 or more layers is one dict of tensors stacked on axis 0
and a shorter group is a list of per-layer dicts, so reference params map
onto it 1:1. The decode cache is grouped the same way (``init_cache``),
written in place; ``position`` is an int or a 0-d tensor on the device.
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
    An MoE model's first ``first_k_dense`` layers are ``moe_dense``, the
    rest ``moe``; the dense and VLM families are ``dense``."""
    if cfg.family not in ("dense", "moe", "vlm") or cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} is not ported yet "
            "(ROADMAP queue 1 item 9c)")
    kinds = [("moe_dense" if i < cfg.moe.first_k_dense else "moe")
             if cfg.family == "moe" else "dense"
             for i in range(cfg.num_layers)]
    groups: list[LayerGroup] = []
    start = 0
    for i in range(1, cfg.num_layers + 1):
        if i == cfg.num_layers or kinds[i] != kinds[start]:
            idx = tuple(range(start, i))
            groups.append(LayerGroup(kinds[start], idx, len(idx) >= 4))
            start = i
    return groups


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
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": layers.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                          dt, dev),
                "layer": blocks.layer_params(gen, cfg, self._mtp_kind(), dev),
                "norm_h": layers.norm_params(cfg, cfg.d_model, dev),
                "norm_e": layers.norm_params(cfg, cfg.d_model, dev),
            }
        return params

    def _mtp_kind(self) -> str:
        return "moe_dense" if self.cfg.family == "moe" else "dense"

    # -- embedding -------------------------------------------------------------

    def embed(self, params: Params, batch: dict):
        """Token embeddings [B,S,d]; under the vision stub a batch's
        ``patch_embeds`` [B,P,d] come first ([B,P+S,d])."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        x = params["embed"][batch["tokens"]].to(cdt)
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(cdt), x], dim=1)
        if cfg.embed_scale:
            x = x * np.sqrt(cfg.d_model)
        return x

    def _positions(self, batch: dict, seq: int, batchsz: int):
        """[B, S] int32 positions 0..S-1; under M-RoPE [3, B, S], the
        batch's own ``positions`` if it brings them. The flash branch masks
        by sequence index, so it refuses caller-given M-RoPE positions."""
        dev = batch["tokens"].device
        p = torch.arange(seq, dtype=torch.int32, device=dev)
        if not self.cfg.mrope:
            return p.expand(batchsz, seq)
        if "positions" not in batch:
            return p.expand(3, batchsz, seq)
        if attention.takes_flash(self.attn_impl, batch["tokens"]):
            raise NotImplementedError(
                f"{self.cfg.name}: the flash branch masks by sequence index "
                "and cannot honour a batch's own M-RoPE positions; set "
                "attn_impl='reference' to attend at those positions")
        return batch["positions"]

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
                               for n in group_cache[0]})
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
        vis = s - tokens.shape[1]
        ce = layers.softmax_xent_fused(h[:, vis:-1, :],
                                       self.head_matrix(params),
                                       tokens[:, 1:])
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp_ce = self._mtp_loss(params, h[:, vis:], tokens, positions)
            metrics["mtp_ce"] = mtp_ce
            total = total + 0.3 * mtp_ce
        return total, metrics

    def _mtp_loss(self, params: Params, h, tokens, positions):
        """DeepSeek-V3 multi-token prediction (depth 1): one extra layer
        predicts t+2 from [h_t ; embed(token_{t+1})]."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        p = params["mtp"]
        h_in = layers.apply_norm(cfg, p["norm_h"], h[:, :-1])
        e_in = layers.apply_norm(cfg, p["norm_e"],
                                 params["embed"][tokens[:, 1:]].to(cdt))
        x = torch.cat([h_in, e_in], dim=-1) @ p["proj"].to(cdt)
        x, _, _ = blocks.layer_fwd(cfg, self._mtp_kind(), p["layer"], x,
                                   positions[..., :-1], 0,
                                   attn_impl=self.attn_impl)
        return layers.softmax_xent_fused(x[:, :-1, :],
                                         self.head_matrix(params),
                                         tokens[:, 2:])

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
        dicts (``attention.init_cache``: K/V, or MLA's latent
        ``{"ckv", "kpe", "pos"}``). A group's capacity is the largest
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
