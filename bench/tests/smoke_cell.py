"""A smoke-sized cell for the CPU tests: the registry's smoke configs of
qwen2-0.5b and qwen2-vl-7b, a short open loop on the port's CPU path."""

from __future__ import annotations

import copy

from bench import cell

MODELS = {
    "qwen2-0.5b": {"num_hidden_layers": 4, "hidden_size": 64,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "intermediate_size": 128, "vocab_size": 256,
                   "tie_word_embeddings": True, "qkv_bias": True,
                   "hidden_act": "silu", "rope_theta": 10000.0,
                   "rms_norm_eps": 1e-06},
    "qwen2-vl-7b": {"num_hidden_layers": 4, "hidden_size": 64,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "intermediate_size": 128, "vocab_size": 256,
                    "tie_word_embeddings": False, "qkv_bias": True,
                    "hidden_act": "silu", "rope_theta": 10000.0,
                    "rms_norm_eps": 1e-06, "mrope_section": [2, 3, 3]},
}


def config(name: str) -> dict:
    """The configuration file ``name`` with the smoke sizes in its place."""
    conf = copy.deepcopy(cell.config(name))
    conf["smoke"] = True
    conf["model"] = dict(MODELS[name])
    return conf


def traffic(cell_name: str) -> dict:
    """The cell's traffic file at smoke lengths and times (its limit,
    placement and clock kept). The run goes on after its window until the
    sample has finished requests, however slow a loaded host makes the
    steps (up to ``finish_s``)."""
    t = copy.deepcopy(cell.traffic(cell_name))
    t.update(arrivals={"process": "poisson", "rate_per_s": 25.0},
             prompt={"dist": "lognormal", "median": 24, "sigma": 0.6,
                     "min": 8, "max": 48},
             output={"dist": "uniform", "min": 6, "max": 14},
             scheduler=dict(t["scheduler"], max_batch=6,
                            prefill_token_budget=48),
             preroll_s=0.3, finish_s=120.0)
    return t


# The smoke runs' traced sub-window, and the served tokens of their sample:
# at this size the float8 control's widest gap needs 160 positions to pass
# the full-size limit on every seed tried (40 left one at 0.199).
TRACE_S = 0.3
SERVED_TOKENS = 160
