"""repro_torch's KV swap (``scheduler/swap.py`` over the fabric's
park/unpark data moves) against the reference: random swap-out/swap-in
interleavings keep every sequence's K/V bytes, keep ``check_invariants()``
after each operation, give the same page ids as the reference, and drain
the ledgers to zero.

``tests/test_scheduler.py::test_swap_random_interleavings_preserve_kv``
fails on the reference with "KV pool exhausted" (e.g. footprints
[1, 3, 6, 6]): its generator asks for more pages than the pool can hand
out once the swap manager has reserved 80 % of the slow domains. The port,
whose control plane is the same code, fails the same way on those inputs
(pinned below). The property here draws footprints within the allocatable
capacity and holds both packages to the stated invariants.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from repro.configs import registry  # noqa: E402
from repro.placement import pool as r_pool  # noqa: E402
from repro.scheduler.swap import KVSwapManager as RSwap  # noqa: E402
from repro_torch.core.dwp import DWPConfig  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.placement import pool as t_pool  # noqa: E402
from repro_torch.scheduler.swap import KVSwapManager as TSwap  # noqa: E402


def _rig(port: bool):
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    mod = t_pool if port else r_pool
    if port:
        cfg = t_config.ModelConfig(**dataclasses.asdict(cfg))
    domains = [mod.MemoryDomain("hbm_local", 8, 819.0, True),
               mod.MemoryDomain("hbm_peer", 10, 0.05, False),
               mod.MemoryDomain("host", 24, 0.016, False)]
    pool = mod.BwapPagePool(cfg, domains, page_size=4,
                            dwp_config=DWPConfig(n=100, c=1),
                            **({"device": "cpu"} if port else {}))
    swap = (TSwap if port else RSwap)(pool, reserve_fraction=0.8)
    return pool, swap


def _fill(pool, pages, value, port):
    if port:
        pool.k_pool[:, pages] = value
        pool.v_pool[:, pages] = -value
    else:
        pool.k_pool = pool.k_pool.at[:, pages].set(value)
        pool.v_pool = pool.v_pool.at[:, pages].set(-value)


def _kv(pool, pages, port):
    if port:
        return pool.k_pool[:, pages].numpy(), pool.v_pool[:, pages].numpy()
    return (np.asarray(pool.k_pool)[:, pages],
            np.asarray(pool.v_pool)[:, pages])


def _interleave(footprints, seed, port):
    pool, swap = _rig(port)
    rng = np.random.default_rng(seed)
    seqs, trail = [], []
    for i, n in enumerate(footprints):
        pages: list[int] = []
        swap.view.grow(pages, n)             # table-tracked, as the engine
        _fill(pool, pages, float(i + 1), port)
        seqs.append({"pages": pages, "fill": float(i + 1), "parked": False})
    for _ in range(12):                      # random preemption points
        s = seqs[int(rng.integers(len(seqs)))]
        if s["parked"]:
            s["pages"], _ = swap.swap_in(s["pages"])
        elif swap.can_swap_out(len(s["pages"])):
            s["pages"], _ = swap.swap_out(s["pages"])
        else:
            continue
        s["parked"] = not s["parked"]
        swap.view.fabric.check_invariants()
        trail.append([list(q["pages"]) for q in seqs])
    for s in seqs:
        k, v = _kv(pool, s["pages"], port)
        assert (k == s["fill"]).all() and (v == -s["fill"]).all()
    # drain: everything back in, freed, reservation closed
    for s in seqs:
        if s["parked"]:
            s["pages"], _ = swap.swap_in(s["pages"])
        swap.view.release(s["pages"])
    swap.close()
    swap.view.fabric.check_invariants()
    assert int(pool.reserved.sum()) == 0
    assert pool.free_count() == pool.total_pages
    return trail


@pytest.mark.parametrize("seed", range(8))
def test_swap_interleavings_preserve_kv_and_match_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    pool, _ = _rig(port=True)
    cap = pool.free_count()                  # allocatable after reservation
    footprints = []
    while len(footprints) < 5:
        n = int(rng.integers(1, 7))
        if sum(footprints) + n > cap:
            break
        footprints.append(n)
    got = _interleave(footprints, seed, port=True)
    want = _interleave(footprints, seed, port=False)
    assert got == want                       # same page ids, every op
    assert len(got) > 0


def test_over_capacity_footprints_fail_alike():
    """The reference property's falsifying inputs exhaust both pools."""
    for port in (False, True):
        with pytest.raises(RuntimeError, match="KV pool exhausted"):
            _interleave([1, 3, 6, 6], 0, port)
