"""Shared helpers of the port's parity tests that run a benchmark of
``benchmarks/`` on both packages: the benchmarks' smoke model with the
reference's params on both sides, and a recorder of the engines a
benchmark builds (their finished requests carry the tokens), with no
artifact written. Also: the port's config of any reference config
(sub-configs included), the raw bits of an array of either package, and
``Pkg``, one package's placement entry points, for the tests that run the
same operations on both. And ``run_example``/``example_summary``, which run
one of ``examples/`` on either package and keep the lines both print
alike."""

import contextlib
import dataclasses
import io
import re
import runpy
import shutil
import sys
from pathlib import Path

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
    # np.ascontiguousarray makes a 0-d array 1-d: keep the shape
    a = np.ascontiguousarray(np.asarray(x)).reshape(np.shape(x))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


class Pkg:
    """One package's entry points and its way of writing a pool."""

    def __init__(self, port: bool, device="cpu"):
        self.port = port
        self.device = device
        if port:
            from repro_torch import cluster
            from repro_torch import scheduler as sched
            from repro_torch.checkpoint import ckpt
            from repro_torch.core import (bwmodel, canonical, dwp, interleave,
                                          simulator, topology)
            from repro_torch.obs.observatory import Observatory
            from repro_torch.placement import (arbiter, executor, fabric,
                                               geometry, persist, policy,
                                               pool, telemetry, zoo)
            from repro_torch.scheduler import KVSwapManager
            from repro_torch.serve import engine, spec
        else:
            from repro import cluster
            from repro import scheduler as sched
            from repro.checkpoint import ckpt
            from repro.core import (bwmodel, canonical, dwp, interleave,
                                    simulator, topology)
            from repro.obs.observatory import Observatory
            from repro.placement import (arbiter, executor, fabric, geometry,
                                         persist, policy, pool, telemetry,
                                         zoo)
            from repro.scheduler import KVSwapManager
            from repro.serve import engine, spec
        self.cluster, self.bwmodel, self.Observatory = (cluster, bwmodel,
                                                        Observatory)
        self.persist, self.geometry, self.pool_mod = persist, geometry, pool
        self.as_view, self.KVSwapManager = fabric.as_view, KVSwapManager
        self.fabric_mod, self.zoo_mod = fabric, zoo
        # the core, the rest of placement, the scheduler and the engine
        self.topology, self.canonical, self.dwp = topology, canonical, dwp
        self.interleave, self.simulator = interleave, simulator
        self.policy, self.executor, self.telemetry = policy, executor, \
            telemetry
        self.arbiter, self.sched, self.ckpt = arbiter, sched, ckpt
        self.engine_mod, self.spec = engine, spec

    def cfg(self, cfg):
        return port_config(cfg) if self.port else cfg

    def pool(self, cfg, domains, page_size=4, geometry=None, **kw):
        """A ``BwapPagePool`` over ``domains`` (tuples of
        ``MemoryDomain``'s fields); the DWP tuner frozen unless
        ``dwp_config`` is given."""
        m = self.pool_mod
        if self.port:
            kw["device"] = self.device
        kw.setdefault("dwp_config", DWPConfig(n=10 ** 6, c=1))
        return m.BwapPagePool(
            self.cfg(cfg), [m.MemoryDomain(*d) for d in domains],
            page_size=page_size, geometry=geometry, **kw)

    def engine(self, cfg, params, pool, **kw):
        """A ``ServeEngine`` (on the pool's device for the port)."""
        if self.port:
            kw["device"] = self.device
        return self.engine_mod.ServeEngine(self.cfg(cfg), params, pool, **kw)

    def put(self, pool, pages, value, which="k"):
        """Write ``value`` (a scalar, or float32 values broadcast to the
        pages' shape) into ``pool``'s ``which`` (``"k"`` or ``"v"``) pool
        at ``pages``."""
        name = which + "_pool"
        arr = getattr(pool, name)
        if self.port:
            arr[:, pages] = torch.from_numpy(
                np.asarray(value, np.float32)).to(arr.device, arr.dtype)
        else:
            setattr(pool, name, arr.at[:, pages].set(
                jnp.asarray(value).astype(arr.dtype)))

    def host(self, x) -> np.ndarray:
        """An array of either package (a pool tensor, a jax array) as
        numpy, float32 values as they are."""
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def fabric(self, cfg, domains, page_size=4, **kw):
        """A ``MemoryFabric`` over ``domains`` (tuples of
        ``MemoryDomain``'s fields)."""
        m = self.pool_mod
        if self.port:
            kw["device"] = self.device
        return self.fabric_mod.MemoryFabric(
            self.cfg(cfg), [m.MemoryDomain(*d) for d in domains],
            page_size=page_size, **kw)

    def zoo(self, arena, seed=0):
        """A ``PageFabricZoo`` over ``arena`` (tuples of ``ByteDomain``'s
        fields)."""
        z = self.zoo_mod
        kw = {"device": self.device} if self.port else {}
        return z.PageFabricZoo([z.ByteDomain(*d) for d in arena], seed=seed,
                               **kw)

    def tier(self, **kw):
        return self.persist.PersistentTier(**kw)

    def set(self, pool, pages, k, v=None):
        """Write float32 values ``k`` (``v``, default ``-k``) into
        ``pool``'s pages, cast to the pool's dtype (round to nearest even
        in both packages)."""
        self.put(pool, pages, k)
        self.put(pool, pages, -k if v is None else v, "v")

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


def table_state(pool) -> dict:
    """A pool's allocator and page table: free lists, refcounts, trie
    nodes ``(parent, block, phys)`` and the allocation cycle."""
    t = pool.table
    return {"free": [list(f) for f in pool.free], "ref": dict(t.ref),
            "trie": {nid: (n.parent, n.block, n.phys)
                     for nid, n in t._nodes.items()},
            "cycle": pool._cycle_pos}


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


def both_close(case, *a, atol=2e-5, **kw):
    """``both`` for a case that returns ``(record, arrays)``: the records
    must be equal, the float arrays (K/V the model computed) within
    ``atol``, since the packages' fp32 kernels round differently. Returns
    the port's ``(record, arrays)``."""
    (ref, ref_arrays), (port, port_arrays) = (case(p, *a, **kw)
                                              for p in BOTH)
    assert equal(port, ref)
    assert len(port_arrays) == len(ref_arrays)
    for x, y in zip(port_arrays, ref_arrays):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)
    return port, port_arrays


ROOT = Path(__file__).resolve().parents[1]
_SNIPPET = re.compile(r"^\s+seq \d+ \[\w+\]: \[")


def run_example(name: str, argv=(), *, port: bool) -> str:
    """The stdout of ``examples/<name>`` (``torch_<name>`` with
    ``--device cpu`` when ``port``). The port's ``main`` takes ``argv``;
    the reference's reads ``sys.argv``. A restart demo's on-disk store is
    removed afterwards unless it was there before."""
    script = ("torch_" if port else "") + name
    main = runpy.run_path(str(ROOT / "examples" / script))["main"]
    store = ROOT / "benchmarks" / "results" / (
        ("torch_" if port else "") + "persist_store_demo")
    existed = store.exists()
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [script, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            main(["--device", "cpu", *argv]) if port else main()
    finally:
        sys.argv = saved
        if not existed:
            shutil.rmtree(store, ignore_errors=True)
    return buf.getvalue()


def example_summary(out: str) -> list[str]:
    """The lines an example prints alike on both packages: all but the
    token snippets (each package draws its own random weights), with the
    restart demo's store path made package-neutral."""
    out = out.replace("torch_persist_store_demo", "persist_store_demo")
    return [ln for ln in out.splitlines() if not _SNIPPET.match(ln)]
