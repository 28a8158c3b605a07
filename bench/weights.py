"""Seeded weights, made on the device in the tree ``repro_torch.models.lm.LM``
takes (one stacked layer group), from the configuration file's sizes.

One ``torch.randn`` call fills a single flat buffer in the served dtype on
the generator's device; each leaf is a view of it (offsets rounded to 256
bytes, as the kernels' tensor maps want), scaled in place. The program and
the reference get the same tensors.

Scales: a projection ``[K, N]`` and the untied head 1 / sqrt(K); the
embedding 1 / sqrt(d), so that a tied head's logits have unit spread as an
untied head's do; biases and norm gains (applied as ``1 + gamma``) 0.1.
"""

from __future__ import annotations

import math

import torch

ALIGN = 128                       # elements: 256 bytes in bf16


def leaves(m: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, std) of every leaf, in buffer order."""
    d, ff, v = m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    nq, nkv = m["num_attention_heads"], m["num_key_value_heads"]
    nl = m["num_hidden_layers"]
    hd = d // nq
    g = ("groups", "0")
    out = [(("embed",), (v, d), 1 / math.sqrt(d)),
           (("final_norm", "gamma"), (d,), 0.1),
           (g + ("norm1", "gamma"), (nl, d), 0.1),
           (g + ("attn", "wq"), (nl, d, nq * hd), 1 / math.sqrt(d)),
           (g + ("attn", "wk"), (nl, d, nkv * hd), 1 / math.sqrt(d)),
           (g + ("attn", "wv"), (nl, d, nkv * hd), 1 / math.sqrt(d)),
           (g + ("attn", "wo"), (nl, nq * hd, d), 1 / math.sqrt(nq * hd))]
    if m.get("qkv_bias", False):
        out += [(g + ("attn", "bq"), (nl, nq * hd), 0.1),
                (g + ("attn", "bk"), (nl, nkv * hd), 0.1),
                (g + ("attn", "bv"), (nl, nkv * hd), 0.1)]
    out += [(g + ("norm2", "gamma"), (nl, d), 0.1),
            (g + ("mlp", "w_up"), (nl, d, ff), 1 / math.sqrt(d)),
            (g + ("mlp", "w_gate"), (nl, d, ff), 1 / math.sqrt(d)),
            (g + ("mlp", "w_down"), (nl, ff, d), 1 / math.sqrt(ff))]
    if not m["tie_word_embeddings"]:
        out.append((("head",), (d, v), 1 / math.sqrt(d)))
    return out


def make(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The params tree of ``m`` from ``seed``, on ``device``."""
    spec = leaves(m)
    offs, n = [], 0
    for _, shape, _ in spec:
        offs.append(n)
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    tree: dict = {}
    for (path, shape, std), off in zip(spec, offs):
        leaf = flat[off:off + math.prod(shape)].view(shape)
        leaf.mul_(std)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    tree["groups"] = [tree["groups"]["0"]]
    return tree
