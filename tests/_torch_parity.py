"""Shared helpers of the port's parity tests that run a benchmark of
``benchmarks/`` on both packages: the benchmarks' smoke model with the
reference's params on both sides, and a recorder of the engines a
benchmark builds (their finished requests carry the tokens), with no
artifact written."""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest

from benchmarks import artifacts
from repro.configs import registry
from repro.models.lm import LM
from repro_torch.convert import params_from_reference
from repro_torch.models import config as t_config


def smoke_pair() -> dict:
    """{port?: (cfg, params)}: the benchmarks' one-layer fp32 qwen2 smoke
    config and its ``PRNGKey(0)`` params (the draw every reference
    benchmark makes), the port's crossed through numpy."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    params = LM(cfg).init(jax.random.PRNGKey(0))
    tcfg = t_config.ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return {False: (cfg, params), True: (tcfg, tparams)}


@contextlib.contextmanager
def engines_of(bench):
    """Run a benchmark of module ``bench`` with every ``ServeEngine`` it
    builds recorded, and ``artifacts.dump`` a no-op."""
    made = []
    base = bench.ServeEngine

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "ServeEngine", Recording)
        mp.setattr(artifacts, "dump", lambda *a, **kw: None)
        yield made


def tokens_of(engines) -> list[dict]:
    return [{s.sid: list(s.tokens) for s in e.finished} for e in engines]
