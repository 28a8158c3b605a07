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
the device. ``param_specs`` and ``fragments`` serve the dry-run, as
``LM``'s do.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve
from repro_torch.models import attention, blocks, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params


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
        x = frames.to(cdt) + sinusoids(f, cfg.d_model,
                                       device=frames.device).to(cdt)
        pos = torch.arange(f, dtype=torch.int32,
                           device=frames.device).expand(b, f)
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
        b, s = tokens.shape
        enc_out = self.encode(params, batch["frames"])
        dev = enc_out.device
        f = enc_out.shape[1]
        enc_pos = torch.arange(f, dtype=torch.int32, device=dev).expand(b, f)
        x = params["embed"][tokens].to(cdt) + params["pos_dec"][:s].to(cdt)
        pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        for p_l in params["dec"]:
            x, _ = blocks.dec_layer_fwd(cfg, p_l, x, pos, enc_out, enc_pos,
                                        attn_impl=self.attn_impl)
        return layers.apply_norm(cfg, params["final_norm"], x)

    def loss(self, params: Params, batch: dict):
        """Mean next-token cross-entropy of ``batch["tokens"]`` [B,S] given
        ``batch["frames"]`` (fused head + CE through the tied embedding).
        Returns (ce, {"ce"})."""
        x = self._decoder(params, batch)
        ce = layers.softmax_xent_fused(x[:, :-1, :], params["embed"].T,
                                       batch["tokens"][:, 1:])
        return ce, {"ce": ce}

    def prefill(self, params: Params, batch: dict):
        """Encoder and decoder forward; returns the last token's logits
        [B,1,V]."""
        cdt = dtype_of(self.cfg.compute_dtype)
        x = self._decoder(params, batch)
        return x[:, -1:, :] @ params["embed"].T.to(cdt)

    def init_cache(self, params_or_specs: Params, batch: int, max_len: int,
                   enc_frames: int, *, device="cuda"):
        """Per decoder layer: the self-attention cache of ``max_len`` slots
        and the cross K/V ``ck``/``cv`` [B, enc_frames, nkv, hd], zero.
        ``params_or_specs`` is unused, as in the reference."""
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

    def decode_step(self, params: Params, cache, tokens, position):
        """tokens [B,1] at ``position`` (a Python int or a 0-d int tensor on
        the cache's device) -> (logits [B,1,V], cache); the self-attention
        cache is written in place."""
        cfg = self.cfg
        cdt = dtype_of(cfg.compute_dtype)
        emb = params["embed"][tokens].to(cdt)
        position = torch.as_tensor(position, dtype=torch.int32,
                                   device=emb.device)
        pos_row = params["pos_dec"].index_select(0, position.reshape(1))
        x = emb + pos_row.to(cdt)
        for p_l, c_l in zip(params["dec"], cache):
            x, _ = blocks.dec_layer_decode(cfg, p_l, x, c_l, position)
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return x @ params["embed"].T.to(cdt), cache
