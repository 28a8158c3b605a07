"""repro_torch's checkpointing (``checkpoint/ckpt.py``) against the
reference: the checkpoint cases of ``tests/test_fault_tolerance.py`` and
``tests/test_placement.py`` under their own names, run on both packages
with the same trees (their manifests and files equal byte for byte), and
checkpoints that cross the packages in both directions, in fp32 and bf16:
a reference checkpoint of the model's params restores onto
``params_from_reference``'s tree, and the port's onto the reference's."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="parity with the reference needs jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bits  # noqa: E402
from repro.checkpoint import ckpt as r_ckpt  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro_torch.checkpoint import ckpt as t_ckpt  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402

CKPT = {False: r_ckpt, True: t_ckpt}


def _files(d) -> dict[str, bytes]:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _tree(port: bool, tree):
    """The same values as the package's tree: jax arrays for the
    reference, CPU tensors (bf16 through its bits) for the port."""
    if not port:
        return jax.tree.map(jnp.asarray, tree)
    return params_from_reference(jax.tree.map(np.asarray, tree),
                                 device="cpu")


# -- tests/test_fault_tolerance.py's checkpoint cases --------------------------

def test_checkpoint_roundtrip_and_hash(tmp_path):
    tree = {"a": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.ones((5,), np.int32)}}
    for port in (False, True):
        d = tmp_path / str(port)
        cm = CKPT[port].CheckpointManager(d)
        t = _tree(port, tree)
        cm.save(7, t, metadata={"x": 1})
        step, out = cm.restore(like=t)
        assert step == 7
        np.testing.assert_array_equal(bits(out["a"]), tree["a"])
        np.testing.assert_array_equal(bits(out["b"]["c"]), tree["b"]["c"])
        if port:
            assert out["a"].dtype == torch.float32 \
                and out["b"]["c"].dtype == torch.int32
    assert _files(tmp_path / "True") == _files(tmp_path / "False")
    for port in (False, True):
        d = tmp_path / str(port)
        f = next((d / "step_0000000007").glob("arr_*.npy"))
        raw = bytearray(f.read_bytes())
        raw[-1] ^= 0xFF                    # corrupt a tensor file
        f.write_bytes(bytes(raw))
        with pytest.raises(IOError):
            CKPT[port].CheckpointManager(d).restore(like=_tree(port, tree))


def test_checkpoint_gc_keeps_last(tmp_path):
    for port in (False, True):
        d = tmp_path / str(port)
        cm = CKPT[port].CheckpointManager(d, keep_last=2)
        t = _tree(port, {"a": np.zeros(3, np.float32)})
        for s in (1, 2, 3, 4):
            cm.save(s, t)
        names = sorted(p.name for p in d.glob("step_*"))
        assert names == ["step_0000000003", "step_0000000004"]
        assert cm.latest_step() == 4
    assert _files(tmp_path / "True") == _files(tmp_path / "False")


# -- tests/test_placement.py's checkpoint staging cases ------------------------

def test_ckpt_plan_staging_spreads_bytes_by_bandwidth():
    plans = []
    for port in (False, True):
        m = CKPT[port]
        tiers = [m.StagingTier("host", 16.0, 1 << 34),
                 m.StagingTier("peer", 4.0, 1 << 34)]
        plan = m.plan_staging([10 << 20, 30 << 20], tiers)
        assert sum(plan["tiers"].values()) == 40 << 20
        assert plan["tiers"]["host"] > 3 * plan["tiers"]["peer"]
        assert plan["drain_time_s"] > 0
        plans.append(plan)
    assert plans[1] == plans[0]
    # the persistence tier's page granularity, and an unplaceable demand
    for kw in ({"page_bytes": 49152}, {"policy": "local_first"}):
        got = [CKPT[p].plan_staging(
            [5 << 20], [CKPT[p].StagingTier("a", 8.0, 1 << 30),
                        CKPT[p].StagingTier("b", 1.0, 1 << 30)], **kw)
            for p in (False, True)]
        assert got[1] == got[0]


def test_ckpt_manager_records_staging_plan(tmp_path):
    tree = {"w": np.ones((64, 64), np.float32)}
    for port in (False, True):
        m = CKPT[port]
        d = tmp_path / str(port)
        mgr = m.CheckpointManager(d, staging_tiers=[
            m.StagingTier("host", 16.0, 1 << 34),
            m.StagingTier("nvme", 2.0, 1 << 34)])
        mgr.save(3, tree)                  # numpy leaves on both sides
        manifest = json.loads(
            (d / "step_0000000003" / "manifest.json").read_text())
        staging = manifest["staging"]
        assert set(staging["tiers"]) == {"host", "nvme"}
        assert staging["policy"] == "bwap_canonical"
        step, restored = mgr.restore(like=tree)
        assert step == 3
        np.testing.assert_array_equal(bits(restored["w"]), tree["w"])
    assert _files(tmp_path / "True") == _files(tmp_path / "False")


def test_ckpt_staging_overflow_does_not_abort_save(tmp_path):
    tree = {"w": np.ones((1024, 1024), np.float32)}
    for port in (False, True):
        m = CKPT[port]
        d = tmp_path / str(port)
        mgr = m.CheckpointManager(d, staging_tiers=[
            m.StagingTier("tiny", 16.0, 2 << 20)])   # 2 MiB < leaf size
        mgr.save(1, _tree(port, tree))              # must still publish
        manifest = json.loads(
            (d / "step_0000000001" / "manifest.json").read_text())
        assert "error" in manifest["staging"]
        step, restored = mgr.restore(like=_tree(port, tree))
        assert step == 1
        np.testing.assert_array_equal(bits(restored["w"]), tree["w"])
    assert _files(tmp_path / "True") == _files(tmp_path / "False")


# -- across the packages ---------------------------------------------------------

def _params(dtype: str):
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=2)
    params = LM(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x.astype(dtype)), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_crosses_packages(tmp_path, dtype):
    """Both packages save the model's params: equal files and manifests
    (JAX's leaf order and ``keystr`` paths); the reference's checkpoint
    restores onto the port's tree with the port's dtypes, and the port's
    onto the reference's, bit for bit."""
    params = _params(dtype)
    trees = {p: _tree(p, params) for p in (False, True)}
    for p in (False, True):
        CKPT[p].CheckpointManager(tmp_path / str(p)).save(
            5, trees[p], metadata={"dtype": dtype})
    files = {p: _files(tmp_path / str(p)) for p in (False, True)}
    assert files[True] == files[False]
    manifest = json.loads(files[True]["step_0000000005/manifest.json"])
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert manifest["paths"] == paths
    assert "['groups'][0][1]['attn']['wq']" in paths
    if dtype == "bfloat16":
        assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16"}
        raw = files[True]["step_0000000005/arr_00000.npy"]
        assert b"'descr': '<V2'" in raw[:128]
    want = jax.tree_util.tree_leaves(params)
    # the reference's checkpoint onto the port's tree
    step, got = t_ckpt.CheckpointManager(tmp_path / "False").restore(
        like=trees[True])
    assert step == 5
    got_leaves = [x for _, x in t_ckpt._flatten(got)]
    assert all(g.dtype == getattr(torch, dtype) for g in got_leaves)
    assert all(np.array_equal(bits(g), bits(w))
               for g, w in zip(got_leaves, want))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, params))
    # the port's checkpoint onto the reference's tree
    step, got = r_ckpt.CheckpointManager(tmp_path / "True").restore(
        like=trees[False])
    for g, w in zip(jax.tree_util.tree_leaves(got), want):
        g = np.asarray(g)
        if dtype == "bfloat16":            # the reference hands back V2
            g = g.view(np.int16)
        assert np.array_equal(g, bits(w))


def test_checkpoint_restore_places_leaves():
    """``shardings`` places the restored leaves: one device for all, or a
    tree of devices with ``like``'s structure; async saves publish on
    ``wait``."""
    import tempfile
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16), None]}
    with tempfile.TemporaryDirectory() as d:
        cm = t_ckpt.CheckpointManager(d, async_save=True)
        cm.save(1, tree)
        tree["a"] += 1                     # after the snapshot: not saved
        cm.wait()
        _, out = cm.restore(like=tree, shardings="cpu")
        assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
        assert out["b"][1] is None and out["b"][0].dtype == torch.bfloat16
        _, out = cm.restore(like=tree, shardings={
            "a": torch.device("cpu"), "b": ["cpu", None]})
        assert out["a"].device.type == "cpu"
        with pytest.raises(ValueError, match="leaves"):
            cm.restore(like={"a": tree["a"]})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_checkpoint_round_trip_bf16(tmp_path, cuda):
    """bf16 params on the card: the port's checkpoint of them equals the
    reference's files, and restores onto the card bit for bit."""
    params = _params("bfloat16")
    on_card = params_from_reference(params, device=cuda)
    t_ckpt.CheckpointManager(tmp_path / "port").save(2, on_card)
    r_ckpt.CheckpointManager(tmp_path / "ref").save(
        2, jax.tree.map(jnp.asarray, params))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    _, got = t_ckpt.CheckpointManager(tmp_path / "port").restore(
        like=on_card, shardings=cuda)
    pairs = zip(t_ckpt._flatten(got), t_ckpt._flatten(on_card))
    assert all(g.device.type == cuda.type and torch.equal(g, w)
               for (_, g), (_, w) in pairs)
