"""Whisper-style encoder-decoder, the audio family (port of
``repro.models.whisper``).

The conv frontend is a stub, as the reference's: a batch brings
precomputed frame embeddings ``frames`` [B, F, d] (what the two conv
layers would emit). The encoder is bidirectional attention over the frames
with sinusoidal positions; the decoder is causal self-attention (the flash
kernel on a card, as ``LM``'s), cross-attention over the encoder's output
and learned positions.

The param tree is the reference's: ``{"embed", "pos_dec", "enc", "dec",
"enc_norm", "final_norm"}``, ``enc`` and ``dec`` lists of per-layer dicts.
The decode cache is a list of per-layer dicts: the self-attention K/V
(``attention.init_cache``) and the cross K/V ``ck``/``cv``. As the
reference's, ``init_cache`` fills ``ck``/``cv`` with zeros and nothing here
writes them: ``decode_step`` attends to whatever the caller put there
(the encoder's K/V projected through each layer's ``cross`` weights, for a
decode that matches ``prefill``). ``decode_step`` writes the
self-attention cache in place; ``position`` is an int or a 0-d tensor on
the device. ``write_cross`` writes the cross K/V from the encoder's output
of a batch's frames. ``param_specs`` and ``fragments`` serve the dry-run,
as ``LM``'s do.

On DTensor params, batches and caches (``sharding/specs.py``'s layouts;
the reference's launcher sets no ``act_spec`` for this family) every entry
point runs sharded, as GSPMD runs the reference's: the frames and tokens
are batch-sharded, attention (the encoder's, the decoder's causal
self-attention and its cross-attention) and the MLP are tensor parallel
over the heads where they divide the model axis, the embedding lookup and
the tied head ``embed.T`` are vocab parallel, and the decoder's learned
positions are read at a replicated position. A cache made with
``init_cache(..., shardings=...)`` holds each rank's shards of the
self-attention K/V (decoded as ``LM``'s) and of ``ck``/``cv``, which each
rank attends over in place (``attention.cross_decode_attention``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve
from repro_torch.models import attention, blocks, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.sharding import dtensor as dtn


def sinusoids(length: int, channels: int, *, device) -> torch.Tensor:
    """[length, channels] fp32: sin then cos of each position over
    ``channels // 2`` geometric timescales up to 10000."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(t), np.cos(t)], axis=1)
    return torch.as_tensor(table, dtype=torch.float32, device=device)


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        self.cfg = cfg
        # the decoder self-attention's ``full_attention`` impl, as
        # ``LM.attn_impl``: None takes the CUDA flash kernel on a card,
        # "reference" the chunked path (and trains on a card)
        self.attn_impl: str | None = None

    # -- parameters ----------------------------------------------------------

    def init(self, gen: torch.Generator, *, device="cuda") -> Params:
        """Random params from ``gen`` (seeded by the caller), placed on
        ``device``."""
        cfg = self.cfg
        dev = resolve(device)
        dt = dtype_of(cfg.param_dtype)
        return {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       dev),
            "pos_dec": (layers._randn(gen, (cfg.max_seq, cfg.d_model), dev)
                        * 0.01).to(dt),
            "enc": [blocks.layer_params(gen, cfg, "enc", dev)
                    for _ in range(cfg.enc_layers)],
            "dec": [blocks.layer_params(gen, cfg, "dec", dev)
                    for _ in range(cfg.num_layers)],
            "enc_norm": layers.norm_params(cfg, cfg.d_model, dev),
            "final_norm": layers.norm_params(cfg, cfg.d_model, dev),
        }

    def param_specs(self) -> Params:
        """The param tree of ``init`` as ``meta`` tensors (nothing drawn
        or allocated)."""
        return self.init(torch.Generator(), device="meta")

    def fragments(self, mode: str, batch: int, seq: int) -> list:
        return []  # 4+4 layers are unrolled: the full count is exact

    # -- encoder ------------------------------------------------------------

    def encode(self, params: Params, frames):
        """frames [B,F,d] -> the encoder's output [B,F,d]."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        b, f, _ = frames.shape
        dev = _device(frames)
        x = frames.to(cdt) + dtn.replicated(
            sinusoids(f, cfg.d_model, device=dev).to(cdt), frames)
        pos = _rows(f, frames)
        for p_l in params["enc"]:
            x, _, _ = blocks.layer_fwd(cfg, "enc", p_l, x, pos, 0)
        return layers.apply_norm(cfg, params["enc_norm"], x)

    # -- decoder ------------------------------------------------------------

    def _decoder(self, params: Params, batch: dict):
        """The normed decoder states [B,S,d] of ``batch["tokens"]`` over
        the encoder's output of ``batch["frames"]``."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        tokens = batch["tokens"]
        s = tokens.shape[1]
        enc_out = self.encode(params, batch["frames"])
        enc_pos = _rows(enc_out.shape[1], enc_out)
        x = dtn.resolved(layers.embed_lookup(params["embed"], tokens)).to(
            cdt) + params["pos_dec"][:s].to(cdt)
        pos = _rows(s, tokens)
        for p_l in params["dec"]:
            x, _ = blocks.dec_layer_fwd(cfg, p_l, x, pos, enc_out, enc_pos,
                                        attn_impl=self.attn_impl)
        return layers.apply_norm(cfg, params["final_norm"], x)

    def loss(self, params: Params, batch: dict):
        """Mean next-token cross-entropy of ``batch["tokens"]`` [B,S] given
        ``batch["frames"]`` (fused head + CE through the tied embedding).
        Returns (ce, {"ce"})."""
        x = dtn.whole_on(self._decoder(params, batch))
        ce = dtn.resolved(layers.softmax_xent_fused(
            x[:, :-1, :], params["embed"].T, batch["tokens"][:, 1:]))
        return ce, {"ce": ce}

    def prefill(self, params: Params, batch: dict):
        """Encoder and decoder forward; returns the last token's logits
        [B,1,V] (split over the model axis on DTensors: the head is vocab
        parallel)."""
        cdt = dtype_of(self.cfg.compute_dtype)
        x = dtn.resolved(dtn.last_along(self._decoder(params, batch), 1))
        return x @ params["embed"].T.to(cdt)

    def init_cache(self, params_or_specs: Params, batch: int, max_len: int,
                   enc_frames: int, *, device="cuda", shardings=None):
        """Per decoder layer: the self-attention cache of ``max_len`` slots
        and the cross K/V ``ck``/``cv`` [B, enc_frames, nkv, hd], zero.
        ``params_or_specs`` is unused, as in the reference. With
        ``shardings`` (``sharding/specs.batch_shardings`` of this cache)
        each rank makes only its own shards, as ``LM.init_cache``."""
        if shardings is not None:
            from repro_torch.sharding import specs
            return specs.full_leaves(
                self.init_cache(None, batch, max_len, enc_frames,
                                device="meta"), shardings,
                lambda path: -1 if path[-1] == "pos" else 0)
        cfg = self.cfg
        dev = resolve(device)
        cdt = dtype_of(cfg.compute_dtype)
        kv = (batch, enc_frames, cfg.num_kv_heads, cfg.head_dim_)
        out = []
        for _ in range(cfg.num_layers):
            c = attention.init_cache(cfg, batch, max_len, device=dev)
            c["ck"] = torch.zeros(kv, dtype=cdt, device=dev)
            c["cv"] = torch.zeros(kv, dtype=cdt, device=dev)
            out.append(c)
        return out

    def write_cross(self, params: Params, cache, frames):
        """Each decoder layer's ``ck``/``cv`` written in place: the
        encoder's output of ``frames`` through the layer's ``cross`` K/V
        products, as the decoder's cross-attention computes them in
        ``prefill`` (the reference leaves them to the caller). On DTensors
        each rank writes its own shard of each leaf. Returns ``cache``."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        nkv, hd = cfg.num_kv_heads, cfg.head_dim_
        enc = dtn.whole_on(self.encode(params, frames).to(cdt))
        b, f, _ = enc.shape
        for p_l, c_l in zip(params["dec"], cache):
            pc = p_l["cross"]
            for leaf, w, bias in (("ck", "wk", "bk"), ("cv", "wv", "bv")):
                new = enc @ pc[w].to(cdt)
                if cfg.qkv_bias:
                    new = new + pc[bias].to(cdt)
                new = new.reshape(b, f, nkv, hd)
                if dtn.is_dt(new):
                    c_l[leaf].to_local().copy_(
                        dtn.settle(new, c_l[leaf].placements).to_local())
                else:
                    c_l[leaf].copy_(new)
        return cache

    def decode_step(self, params: Params, cache, tokens, position):
        """tokens [B,1] at ``position`` (a Python int, a 0-d int tensor on
        the cache's device, or a replicated 0-d DTensor) -> (logits
        [B,1,V], cache); the self-attention cache is written in place."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        emb = dtn.resolved(layers.embed_lookup(params["embed"], tokens)).to(
            cdt)
        position = attention.as_position(position, emb)
        pos_dec = params["pos_dec"]
        if dtn.is_dt(pos_dec):                  # replicated: read locally
            pos_row = dtn.on_shards(
                lambda t: t.index_select(0, position.reshape(1)),
                pos_dec.placements, pos_dec)
        else:
            pos_row = pos_dec.index_select(0, position.reshape(1))
        x = emb + pos_row.to(cdt)
        for p_l, c_l in zip(params["dec"], cache):
            x, _ = blocks.dec_layer_decode(cfg, p_l, x, c_l, position)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return x @ params["embed"].T.to(cdt), cache


def _device(t):
    return t.to_local().device if dtn.is_dt(t) else t.device


def _rows(n: int, like):
    """Positions 0..n-1 [B, n] int32 for ``like``'s batch (dim 0), placed
    as its rows on DTensors."""
    p = torch.arange(n, dtype=torch.int32, device=_device(like))
    return dtn.rows_like(p.expand(like.shape[0], n), like)
