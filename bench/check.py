"""How ``correct`` is decided for a served model: a sample of the requests
the timed path finished, drawn from the seed with the longest among them,
is run once through the float32 reference over each prompt and its served
tokens; the number compared is the widest gap by which a served token's
reference logit lies below the reference's best at that position."""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import qwen2


def sample(done: list[tuple[list[int], list[int]]], seed: int,
           served_tokens: int) -> list[int]:
    """Indices into ``done`` (each (prompt, served tokens)): the longest
    request, then others in an order drawn from the seed, until the sample
    holds ``served_tokens`` served tokens or every request."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i][0]) + len(done[i][1]))
    order = [longest] + [int(i) for i in np.random.default_rng(seed)
                         .permutation(len(done)) if i != longest]
    out, n = [], 0
    for i in order:
        if n >= served_tokens:
            break
        out.append(i)
        n += len(done[i][1])
    return out


def gaps(m: dict, params: dict, prompt, served, quant=None):
    """Per served token: (reference best - reference logit of the token
    chosen), where the chosen token is the served one, or with ``quant``
    the one the lower-precision reference puts first. Float64 numpy."""
    seq = list(prompt) + list(served[:-1])
    rows = range(len(prompt) - 1, len(seq))
    ref = qwen2.logits(m, params, seq, rows)
    if quant is None:
        chosen = torch.as_tensor(list(served), device=ref.device)
    else:
        chosen = qwen2.logits(m, params, seq, rows, quant).argmax(-1)
    best = ref.max(-1).values
    got = ref.gather(1, chosen[:, None])[:, 0]
    return (best - got).double().cpu().numpy()
