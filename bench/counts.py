"""The benchmark's yardstick: the card's published peaks and the operations
and bytes each measured launch needs, computed from shapes alone.

Frozen with the benchmark: a later change to the program cannot move what a
roofline share or a model-FLOPs share is measured against. The peak table is
``chip_smoke._bound``'s (NVIDIA H100 SXM data sheet, dense, 700 W).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # HBM3
BF16 = 2                     # bytes an element


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(start: int, t: int) -> int:
    """(query, key) pairs of ``t`` queries at absolute positions ``start ..
    start + t - 1``, each seeing every key up to its own position."""
    return t * start + t * (t + 1) // 2


def paged_walk(chunks, nq: int, nkv: int, hd: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one paged-attention launch over ``chunks``, a list
    of ``(start, t)``: ``t`` real queries at positions ``start ..``. Each
    sequence's attended K/V (``start + t`` keys) read once, q read and the
    output written once; 4 nq hd FLOPs a causal (query, key) pair."""
    flops = nbytes = 0
    for start, t in chunks:
        flops += 4 * nq * hd * causal_pairs(start, t)
        nbytes += ((start + t) * 2 * nkv * hd + 2 * t * nq * hd) * BF16
    return float(flops), float(nbytes)


def rowwise(m: int, n: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of ``[m, k] @ [k, n]``: W, A and the output once."""
    return 2.0 * m * n * k, float((k * n + m * k + m * n) * BF16)


def non_embedding_params(m: dict) -> int:
    """Weights a token passes through below the head: every decoder
    layer's projections, biases and norms, and the final norm (the
    configuration file's sizes, Hugging Face key names)."""
    d, ff = m["hidden_size"], m["intermediate_size"]
    nq, nkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = d // nq
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    bias = (nq + 2 * nkv) * hd if m.get("qkv_bias", False) else 0
    layer = attn + bias + 3 * d * ff + 2 * d
    return m["num_hidden_layers"] * layer + d


def model_flops(m: dict, tokens: int, keys: int, logit_rows: int) -> float:
    """Model FLOPs of ``tokens`` processed tokens that see ``keys`` keys in
    all (each its own position and those before it): 2 x the non-embedding
    parameters a token, 4 nq hd a (token, key) pair in every layer's
    attention, and 2 d V a logit row."""
    d, v = m["hidden_size"], m["vocab_size"]
    nq, nl = m["num_attention_heads"], m["num_hidden_layers"]
    hd = d // nq
    return (2.0 * non_embedding_params(m) * tokens
            + 4.0 * nq * hd * nl * keys + 2.0 * d * v * logit_rows)
