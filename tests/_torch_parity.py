"""Shared helpers of the port's parity tests that run a benchmark of
``benchmarks/`` on both packages: the benchmarks' smoke model with the
reference's params on both sides, and a recorder of the engines a
benchmark builds (their finished requests carry the tokens), with no
artifact written. Also: the port's config of any reference config
(sub-configs included), the raw bits of an array of either package, and
``Pkg``, one package's placement entry points, for the tests that run the
same operations on both."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest

from benchmarks import artifacts
from repro.configs import registry
from repro.models.lm import LM
from repro_torch.checkpoint.ckpt import host_array
from repro_torch.convert import params_from_reference
from repro_torch.core.dwp import DWPConfig
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


def port_config(cfg):
    """The port's ``ModelConfig`` with a reference config's fields, its
    MoE/MLA/SSM/xLSTM sub-configs as the port's dataclasses (no model
    family needs to be ported for a pool of its geometry)."""
    subs = {"moe": t_config.MoEConfig, "mla": t_config.MLAConfig,
            "ssm": t_config.SSMConfig, "xlstm": t_config.XLSTMConfig}
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in subs.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return t_config.ModelConfig(**kw)


def bits(x) -> np.ndarray:
    """An array's raw element bits as numpy, from a tensor (any device) or
    a jax/numpy array: bfloat16 as int16, everything else as is, so
    ``np.array_equal`` of two ``bits`` is bit-for-bit equality."""
    if isinstance(x, torch.Tensor):
        return host_array(x.cpu())
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


class Pkg:
    """One package's entry points and its way of writing a pool."""

    def __init__(self, port: bool, device="cpu"):
        self.port = port
        self.device = device
        if port:
            from repro_torch import cluster
            from repro_torch.core import bwmodel
            from repro_torch.obs.observatory import Observatory
            from repro_torch.placement import fabric, geometry, persist, pool
            from repro_torch.scheduler import KVSwapManager
        else:
            from repro import cluster
            from repro.core import bwmodel
            from repro.obs.observatory import Observatory
            from repro.placement import fabric, geometry, persist, pool
            from repro.scheduler import KVSwapManager
        self.cluster, self.bwmodel, self.Observatory = (cluster, bwmodel,
                                                        Observatory)
        self.persist, self.geometry, self.pool_mod = persist, geometry, pool
        self.as_view, self.KVSwapManager = fabric.as_view, KVSwapManager

    def cfg(self, cfg):
        return port_config(cfg) if self.port else cfg

    def pool(self, cfg, domains, page_size=4, geometry=None):
        m = self.pool_mod
        kw = {"device": self.device} if self.port else {}
        return m.BwapPagePool(
            self.cfg(cfg), [m.MemoryDomain(*d) for d in domains],
            page_size=page_size, geometry=geometry,
            dwp_config=DWPConfig(n=10 ** 6, c=1), **kw)

    def tier(self, **kw):
        return self.persist.PersistentTier(**kw)

    def set(self, pool, pages, k, v=None):
        """Write float32 values ``k`` (``v``, default ``-k``) into
        ``pool``'s pages, cast to the pool's dtype (round to nearest even
        in both packages)."""
        v = -k if v is None else v
        if self.port:
            dt = pool.k_pool.dtype
            pool.k_pool[:, pages] = torch.from_numpy(k).to(
                pool.k_pool.device, dt)
            pool.v_pool[:, pages] = torch.from_numpy(v).to(
                pool.v_pool.device, dt)
        else:
            dt = pool.k_pool.dtype
            pool.k_pool = pool.k_pool.at[:, pages].set(
                jnp.asarray(k).astype(dt))
            pool.v_pool = pool.v_pool.at[:, pages].set(
                jnp.asarray(v).astype(dt))

    def fill(self, pool, pid, val):
        shape = (pool.k_pool.shape[0],) + tuple(pool.k_pool.shape[2:])
        self.set(pool, [pid], np.full((shape[0], 1) + shape[1:], float(val),
                                      np.float32))

    def kv(self, pool, pages):
        """Raw bits of ``pool``'s K and V at ``pages``."""
        return bits(pool.k_pool[:, list(pages)]), \
            bits(pool.v_pool[:, list(pages)])

    def page_shape(self, pool, pages):
        return (pool.k_pool.shape[0], len(pages)) + tuple(
            pool.k_pool.shape[2:])


BOTH = (Pkg(False), Pkg(True))


def equal(a, b) -> bool:
    """Nested equality of records that may hold numpy arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a == b


def both(case, *a, **kw):
    """Run ``case(pkg, ...)`` on the reference and on the port; the port's
    record must equal the reference's. Returns the port's."""
    ref, port = (case(p, *a, **kw) for p in BOTH)
    assert equal(port, ref)
    return port
