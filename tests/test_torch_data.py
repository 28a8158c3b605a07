"""repro_torch's data pipeline (``data/pipeline.py``) against the
reference's: both are numpy, so the synthetic and memory-mapped batches,
the router's shard assignments after every scripted fetch (the
reference's straggler case included), its migration counts and host
weights are equal exactly, and so are the prefetch loaders' first steps
and batches."""

import numpy as np
import pytest

from repro.data import pipeline as r_pipe
from repro_torch.data import pipeline as t_pipe

PIPES = (r_pipe, t_pipe)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_the_reference(seed):
    for shard, step, bs in ((0, 0, 4), (3, 17, 2), (7, 123456, 8)):
        got = [p.ShardedTokenDataset(97, 32, num_shards=8, seed=seed)
               .batch(shard, step, bs) for p in PIPES]
        assert got[1].dtype == np.int32 and got[1].shape == (bs, 32)
        np.testing.assert_array_equal(got[1], got[0])


def test_memmap_batches_equal_the_reference(tmp_path):
    files = []
    for i in range(2):
        f = tmp_path / f"shard{i}.bin"
        np.arange(i * 1000, i * 1000 + 777, dtype=np.int32).tofile(f)
        files.append(str(f))
    ds = [p.ShardedTokenDataset(5000, 16, num_shards=3, files=files)
          for p in PIPES]
    for shard in range(3):
        for step in (0, 1, 9, 40):
            got = [d.batch(shard, step, 3) for d in ds]
            np.testing.assert_array_equal(got[1], got[0])


def _router_trace(pipe, host_bws, script):
    """(assignment, migrations, weights, rebalanced?) after each fetch of
    ``script`` [(host, latency)]."""
    r = pipe.BwapDataRouter(64, host_bws)
    out = [(r.assignment.copy(), r.migrations, None, None)]
    for host, lat in script:
        hit = r.record_fetch(host, lat)
        out.append((r.assignment.copy(), r.migrations,
                    [h.bw_weight for h in r.hosts], hit))
    return out, [r.shards_of(h) for h in range(len(host_bws))]


SCRIPTS = {
    # the reference's case: host 3 is 5x slower than the others
    "straggler": ([1.0, 1.0, 1.0, 1.0],
                  [(h, 0.05 if h != 3 else 0.25)
                   for _ in range(12) for h in range(4)]),
    "weighted_recovering": ([1.0, 0.8, 0.6],
                            [(h, lat) for i in range(10)
                             for h, lat in ((0, 0.02), (1, 0.02 + 0.01 * i),
                                            (2, 0.3 if i < 5 else 0.02))]),
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_router_equals_the_reference(case):
    bws, script = SCRIPTS[case]
    (ref, ref_shards), (port, port_shards) = (
        _router_trace(p, bws, script) for p in PIPES)
    assert len(ref) == len(port)
    for (a0, m0, w0, h0), (a1, m1, w1, h1) in zip(ref, port):
        np.testing.assert_array_equal(a1, a0)
        assert (m1, w1, h1) == (m0, w0, h0)
    for a, b in zip(ref_shards, port_shards):
        np.testing.assert_array_equal(b, a)
    assert any(hit for *_, hit in port[1:])       # a rebalance happened
    if case == "straggler":
        r = t_pipe.BwapDataRouter(64, bws)
        before = r.shards_of(3).size
        for host, lat in script:
            r.record_fetch(host, lat)
        assert r.shards_of(3).size < before and r.migrations > 0
        assert sum(r.shards_of(h).size for h in range(4)) == 64


def test_prefetch_loader_yields_deterministic_batches():
    """The reference's case (tests/test_fault_tolerance.py) on both
    packages: the loader's batch is the dataset's batch of its step's
    shard, and the port's step and batch equal the reference's."""
    got = []
    for p in PIPES:
        ds = p.ShardedTokenDataset(vocab_size=97, seq_len=8, num_shards=4,
                                   seed=1)
        router = p.BwapDataRouter(4, [1, 1, 1, 1])
        loader = p.PrefetchLoader(ds, router, host=0, batch_size=2)
        try:
            s1, b1 = next(loader)
        finally:
            loader.close()
        got.append((s1, b1))
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()
    shards = router.shards_of(0)
    again = ds.batch(int(shards[s1 % shards.size]) if len(shards) else 0,
                     s1, 2)
    assert b1.shape == (2, 8)
    assert b1.dtype == np.int32
    np.testing.assert_array_equal(b1, again)
    assert got[1][0] == got[0][0]
    np.testing.assert_array_equal(got[1][1], got[0][1])
