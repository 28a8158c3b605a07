"""repro_torch's weighted ZeRO (``sharding/zero.py``), sharding rules
(``sharding/specs.py``), meshes (``launch/mesh.py``) and compressed
all-reduce (``train/compress.py``) against the reference's.

The reference's four ``zero`` cases run on both packages
(``_torch_parity.both``: equal page tables and Eq.-1 times; the
hypothesis property on explicit examples). The parameter, gradient and
optimizer-state specs of every leaf of every config, on the reference
test's 16 x 16 stand-in mesh and on 2 x 16 x 16, equal the reference's
``PartitionSpec``s as tuples (the reference's ``NamedSharding`` is
replaced by its spec). The collectives run as gloo ranks on the CPU
(``tests/_torch_dist.py``, each with its own timeout): the weighted
all-gather on 8 ranks, the compressed all-reduce on 4 (the sum of what
each rank sent, and its residual identity) and on 1 (equal to the
reference's, bit for bit), and the reference's elastic-restore case: a
reference checkpoint restored onto an 8-rank, then a 4-rank (data, model)
mesh as DTensors, each leaf's full tensor equal to the saved bytes and
the reassembled params' loss equal to the unsharded port's.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
from _torch_parity import both, port_config  # noqa: E402
from repro.checkpoint import ckpt as r_ckpt  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.sharding import specs as r_specs  # noqa: E402
from repro.sharding import zero as r_zero  # noqa: E402
from repro.train import compress as r_compress  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import trainstep as r_ts  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.sharding import specs as t_specs  # noqa: E402
from repro_torch.sharding import zero as t_zero  # noqa: E402
from repro_torch.train import compress as t_compress  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainstep as t_ts  # noqa: E402


def _zero(pkg):
    return t_zero if pkg.port else r_zero


def _tiers(z, caps=(100, 1000, 1000), bws=(50.0, 12.5, 16.0)):
    return [z.TierSpec(f"t{i}", b, c)
            for i, (b, c) in enumerate(zip(bws, caps))]


# -- tests/test_zero_and_sharding.py's zero cases, on both packages ------------

def test_tier_split_proportional_when_unconstrained():
    def case(pkg):
        z = _zero(pkg)
        a = z.tier_split(1000, _tiers(z, caps=(10_000, 10_000, 10_000)))
        frac = np.bincount(a, minlength=3) / 1000
        bw = np.asarray([50.0, 12.5, 16.0])
        np.testing.assert_allclose(frac, bw / bw.sum(), atol=0.02)
        return a
    both(case)


def test_tier_split_respects_capacity():
    def case(pkg):
        z = _zero(pkg)
        a = z.tier_split(1000, _tiers(z, caps=(100, 10_000, 10_000)))
        counts = np.bincount(a, minlength=3)
        assert counts[0] <= 100
        assert counts.sum() == 1000
        return a
    both(case)


def test_bwap_tier_split_dominates_baselines():
    def case(pkg):
        z = _zero(pkg)
        rec = []
        for cap0 in (100, 300, 500, 800, 1000):
            tiers = _tiers(z, caps=(cap0, 2000, 2000))
            t_b = z.stream_update_time(z.tier_split(1000, tiers), tiers,
                                       1 << 20)
            t_u = z.stream_update_time(z.uniform_split(1000, tiers), tiers,
                                       1 << 20)
            t_h = z.stream_update_time(z.hbm_first_split(1000, tiers),
                                       tiers, 1 << 20)
            assert t_b <= t_u + 1e-9, cap0
            assert t_b <= t_h + 1e-9, cap0
            rec.append((t_b, t_u, t_h))
        return rec
    both(case)


@pytest.mark.parametrize("bws,pages", [([1.0, 2.0], 64),
                                       ([900.0, 1.0, 37.5], 511),
                                       ([3.0, 3.0, 5.0, 7.0, 11.0], 200)])
def test_weighted_partition_fractions(bws, pages):
    def case(pkg):
        a = _zero(pkg).weighted_page_partition(pages, np.asarray(bws))
        frac = np.bincount(a, minlength=len(bws)) / pages
        w = np.asarray(bws) / np.sum(bws)
        np.testing.assert_allclose(frac, w,
                                   atol=len(bws) * 1.5 / pages + 1e-9)
        return a
    both(case)


# -- specs --------------------------------------------------------------------

class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _spec_leaves(tree) -> list:
    """A port spec tree's specs (tuples) in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int8": torch.int8}


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_TORCH[s.dtype.name], device="meta"), tree)


@pytest.mark.parametrize("mesh", [FakeMesh, FakePodMesh],
                         ids=["16x16", "2x16x16"])
def test_param_grad_opt_specs_equal_the_reference(mesh, monkeypatch):
    from jax.sharding import PartitionSpec as P
    monkeypatch.setattr(r_specs, "NamedSharding", lambda m, spec: spec)
    mesh = mesh()
    n = 0
    for arch in r_registry.ARCH_IDS:
        rcfg = r_registry.get_config(arch)
        tcfg = port_config(rcfg)
        model = r_registry.make_model(rcfg)
        pspecs = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        ospecs = r_opt.opt_state_specs(r_ts.opt_config_for(rcfg), pspecs)
        tparams = _meta(pspecs)
        tstate = t_opt.opt_state_specs(t_ts.opt_config_for(tcfg), tparams)
        pairs = [
            (r_specs.param_shardings(rcfg, mesh, pspecs),
             t_specs.param_specs_of(tcfg, mesh, tparams)),
            (r_specs.grad_shardings(rcfg, mesh, pspecs),
             t_specs.grad_specs_of(tcfg, mesh, tparams)),
            (r_specs.opt_shardings(rcfg, mesh, ospecs),
             t_specs.opt_specs_of(tcfg, mesh, tstate)),
        ]
        for ref, port in pairs:
            want = jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, P))
            got = _spec_leaves(port)
            assert len(got) == len(want), arch
            for w, g in zip(want, got):
                assert tuple(w) == g, (arch, w, g)
            n += len(got)
        # the per-leaf rules on the reference's paths, zero_spec included
        for path, leaf in jax.tree_util.tree_flatten_with_path(pspecs)[0]:
            tpath = tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in path)
            pspec = t_specs.param_spec_for(tcfg, mesh, tpath, leaf.shape)
            assert pspec == tuple(r_specs.param_spec_for(
                rcfg, mesh, path, leaf.shape)), (arch, path)
            assert t_specs.zero_spec(mesh, pspec, leaf.shape) == tuple(
                r_specs.zero_spec(mesh, P(*pspec), leaf.shape))
    assert n > 1500


def test_param_sharding_rules_head_alignment():
    """The reference's case: attention TP only when heads divide the model
    axis (the 14-GiB all-reduce regression test, in rule form)."""
    mesh = FakeMesh()
    qwen = port_config(r_registry.get_config("qwen2-0.5b"))   # 14 heads
    intern = port_config(r_registry.get_config("internlm2-20b"))   # 48
    assert t_specs.param_spec_for(qwen, mesh, ("attn", "wq"),
                                  (896, 896)) == (None, None)
    assert t_specs.param_spec_for(intern, mesh, ("attn", "wq"),
                                  (6144, 6144)) == (None, "model")
    # MLP stays TP for both
    assert t_specs.param_spec_for(qwen, mesh, ("mlp", "w_up"),
                                  (896, 4864)) == (None, "model")


def test_meshes_need_a_matching_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_debug_mesh(8, 2, device_type="cpu")
    assert t_mesh.dp_axes(FakePodMesh()) == ("pod", "data")
    assert t_mesh.axis_sizes(FakeMesh()) == {"data": 16, "model": 16}


# -- collectives on gloo ranks ---------------------------------------------------

WEIGHTS = [4.0, 2, 1, 1, 1, 1, 1, 1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two spawns of gloo ranks, shared by the collective cases: 8 ranks
    (the weighted all-gather, then the elastic restore onto a 4 x 2
    mesh) and 4 ranks (the compressed all-reduce, then the restore onto
    2 x 2). The checkpoint is the reference's, of the crash-restart
    config's params; also returned: those params and the unsharded port's
    loss of them (one torch thread, as in each rank)."""
    d = tmp_path_factory.mktemp("elastic")
    cfg = dataclasses.replace(r_registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=2, d_ff=64)
    params = jax.jit(RLM(cfg).init)(jax.random.PRNGKey(0))
    r_ckpt.CheckpointManager(d).save(3, params)
    tcfg = port_config(cfg)
    tokens = np.zeros((4, 8), np.int64)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, _ = TLM(tcfg).loss(params_from_reference(
            jax.tree.map(np.asarray, params), device="cpu"),
            {"tokens": torch.from_numpy(tokens)})
    finally:
        torch.set_num_threads(n)
    elastic = ("elastic", (str(d), dataclasses.asdict(tcfg), tokens))
    return {8: _torch_dist.run(8, [("allgather", (WEIGHTS,)), elastic],
                               timeout=180),
            4: _torch_dist.run(4, [("compress", ()), elastic], timeout=180),
            "params": [np.asarray(x) for x in jax.tree.leaves(params)],
            "loss": float(loss)}


def test_weighted_allgather_on_8_ranks(ranks):
    full = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
    for r in ranks[8]:
        owner, got = r["allgather"]
        np.testing.assert_array_equal(
            owner, r_zero.weighted_page_partition(32, np.asarray(WEIGHTS)))
        np.testing.assert_array_equal(got, full)


def test_compressed_psum_on_4_ranks(ranks):
    out = [r["compress"] for r in ranks[4]]
    for k in ("w", "b"):
        sent = [r["g"][k] - r["res"][k] for r in out]    # what each sent
        want = np.sum(sent, axis=0)
        for r in out:
            np.testing.assert_array_equal(r["red"][k], out[0]["red"][k])
            np.testing.assert_allclose(r["red"][k], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            # one rank's error: at most half an int8 step of its block
            scale = np.abs(r["g"][k]).max() / 127.0
            assert np.abs(r["res"][k]).max() <= scale * 0.5 * 1.01


def test_compressed_psum_on_1_rank_equals_the_reference(tmp_path):
    """The reference's case (tests/test_fault_tolerance.py) on the port:
    error within a block's int8 step, residual = what was lost; and the
    reduced grads and residuals equal the reference's bit for bit."""
    import torch.distributed as dist

    from repro.compat import make_mesh
    g = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    tree = {"w": g, "v": [g[:7, :9].copy()]}
    r_red, r_res = r_compress.compressed_psum_grads(
        jax.tree.map(jnp.asarray, tree),
        r_compress.init_residuals(jax.tree.map(jnp.asarray, tree)),
        make_mesh((1,), ("data",)))
    tt = params_from_reference(tree, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        red, res = t_compress.compressed_psum_grads(
            tt, t_compress.init_residuals(tt))
    finally:
        dist.destroy_process_group()
    for a, b in zip(jax.tree.leaves((r_red, r_res)),
                    t_opt.tree_leaves((red, res))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    err = np.abs(red["w"].numpy() - g)
    assert err.max() <= np.abs(g).max() / 127.0 * 1.01
    np.testing.assert_allclose(res["w"].numpy(), g - red["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_elastic_restore_across_meshes(ranks):
    """The reference's case on the port: a (reference) checkpoint restored
    onto an 8-rank, then a 4-rank (data, model) mesh. Each leaf's full
    tensor equals the saved bytes, some leaves are sharded, and the loss
    computed on the restored DTensor params is the unsharded port's within
    1e-5 relative (the ranks' partial sums are reduced in another order
    than one device's products)."""
    for world in (8, 4):
        for r in ranks[world]:
            step, sharded, local, leaves, loss = r["elastic"]
            assert step == 3 and sharded > 0, world
            assert np.isfinite(loss), world
            assert abs(loss / ranks["loss"] - 1) <= 1e-5, \
                (world, loss, ranks["loss"])
            for a, b in zip(ranks["params"], leaves):
                np.testing.assert_array_equal(b, a)
        # the model axis (2) splits the MLP's d_ff, the data axis nothing
        assert any(s[-1] == 32 for s in ranks[world][0]["elastic"][2]), \
            world
