"""repro_torch's dry-run (``launch/dryrun.py``), roofline
(``roofline/analyze.py``, ``roofline/counter.py``), ``LM.param_specs`` /
``fragments``, ``EncDecLM``'s and ``registry.input_specs`` against the
reference's.

Against the reference, exactly: the param specs of all ten configs at full
width (the reference's through ``jax.eval_shape``, which compiles
nothing); ``input_specs`` and ``_scale_batch`` for every arch x ``SHAPES``
row, decode caches included; ``fragments`` for every arch x train /
prefill / decode at each shape's per-device batch and sequence (names,
trip counts, argument shapes, dtypes and kinds); the per-device argument
bytes of every supported cell on the reference test's stand-in meshes,
against the shard shapes the reference's own layout rules give; the
roofline arithmetic on the same parts (and a group's reach against the
reference's HLO replica-group parser). Against the port itself: the
fragment identity on a dense smoke config (integer FLOPs); the fake
trace's FLOPs against ``FlopCounterMode`` over a real CPU step; the
counter's bytes and peak on a known program. And the reference's
``test_system.py::test_dryrun_driver_small_cell`` on the port, in process.
Only smoke widths are traced; full width only builds specs (meta tensors).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import port_config  # noqa: E402
from test_torch_zero_sharding import FakeMesh, FakePodMesh  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.roofline import analyze as r_analyze  # noqa: E402
from repro.sharding import specs as r_specs  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import trainstep as r_ts  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.roofline import analyze as t_analyze  # noqa: E402
from repro_torch.roofline import counter  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainstep as t_ts  # noqa: E402

ARCHS = r_registry.ARCH_IDS


def _dt(x) -> str:
    return str(x.dtype).split(".")[-1]


def _port_leaves(tree, path=()):
    """(path, shape, dtype name) of a port tree's leaves in JAX's order
    (dict keys sorted); non-tensor leaves as themselves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _port_leaves(v, path + (i,))]
    if isinstance(tree, torch.Tensor):
        return [(path, tuple(tree.shape), _dt(tree))]
    return [(path, tree)]


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for path, leaf in flat:
        p = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            out.append((p, tuple(leaf.shape), np.dtype(leaf.dtype).name))
        else:
            out.append((p, leaf))
    return out


@functools.lru_cache(maxsize=None)
def _ref_model(arch):
    """The reference's model of ``arch`` with its param specs made once
    (its ``fragments`` ask for them on every call)."""
    model = r_registry.make_model(r_registry.get_config(arch))
    specs = model.param_specs()
    model.param_specs = lambda: specs
    return model


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return t_registry.make_model(t_registry.get_config(arch))


# -- specs --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    want = _ref_leaves(_ref_model(arch).param_specs())
    got = _port_leaves(_port_model(arch).param_specs())
    assert got == want
    assert all(t.is_meta for t in t_opt.tree_leaves(
        _port_model(arch).param_specs()))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    rcfg, tcfg = r_registry.get_config(arch), t_registry.get_config(arch)
    assert port_config(rcfg) == tcfg
    for name, shape in r_registry.SHAPES.items():
        tshape = t_registry.SHAPES[name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(shape)
        want = _ref_leaves(r_registry.input_specs(rcfg, shape))
        got = t_registry.input_specs(tcfg, tshape)
        assert _port_leaves(got) == want, (arch, name)
        assert all(t.is_meta for t in t_opt.tree_leaves(got))
        for kw in (dict(batch=3), dict(batch=2, seq=96)):
            assert _port_leaves(t_registry.input_specs(tcfg, tshape, **kw)) \
                == _ref_leaves(r_registry.input_specs(rcfg, shape, **kw))
        for scale in (1.0, 0.5, 1 / 64, 1e-6, 2.0):
            assert t_registry._scale_batch(tcfg, tshape, scale) == \
                r_registry._scale_batch(rcfg, shape, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_fragments_equal_the_reference(arch):
    rm, tm = _ref_model(arch), _port_model(arch)
    n = 0
    for shape in r_registry.SHAPES.values():
        b, s = max(shape.global_batch // 16, 1), shape.seq_len
        for mode in ("train", "prefill", "decode"):
            want, got = rm.fragments(mode, b, s), tm.fragments(mode, b, s)
            assert [f.name for f in got] == [f.name for f in want]
            for w, g in zip(want, got):
                assert g.extra_trips == w.extra_trips, (mode, w.name)
                assert g.arg_kinds == w.arg_kinds, (mode, w.name)
                assert _port_leaves(g.args) == _ref_leaves(w.args), \
                    (mode, w.name)
                n += 1
    assert n > 0 or arch == "whisper-tiny"


# -- argument bytes on the reference test's stand-in meshes -------------------

def _ref_shard_bytes(specs_tree, shardings, mesh) -> int:
    from jax.sharding import PartitionSpec as P
    sizes = mesh.shape
    total = 0
    for leaf, spec in zip(jax.tree.leaves(specs_tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: isinstance(x, P))):
        n = np.dtype(leaf.dtype).itemsize
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (
                len(leaf.shape) - len(spec))):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        total += n
    return total


@pytest.mark.parametrize("mesh", [FakeMesh, FakePodMesh],
                         ids=["16x16", "2x16x16"])
def test_argument_bytes_equal_the_reference_layouts(mesh, monkeypatch):
    monkeypatch.setattr(r_specs, "NamedSharding", lambda m, spec: spec)
    mesh = mesh()
    cells = 0
    for arch in ARCHS:
        rcfg, tcfg = r_registry.get_config(arch), t_registry.get_config(arch)
        pspecs = _ref_model(arch).param_specs()
        params = _ref_shard_bytes(
            pspecs, r_specs.param_shardings(rcfg, mesh, pspecs), mesh)
        ostate = None
        for name, shape in r_registry.SHAPES.items():
            if not r_registry.cell_supported(rcfg, shape)[0]:
                continue
            bspecs = r_registry.input_specs(rcfg, shape)
            want = params + _ref_shard_bytes(
                bspecs, r_specs.batch_shardings(rcfg, mesh, bspecs), mesh)
            if shape.kind == "train":
                if ostate is None:
                    ospecs = r_opt.opt_state_specs(
                        r_ts.opt_config_for(rcfg), pspecs)
                    ostate = _ref_shard_bytes(
                        ospecs, r_specs.opt_shardings(rcfg, mesh, ospecs),
                        mesh)
                want += ostate
            got = dryrun.argument_bytes(tcfg, t_registry.SHAPES[name], mesh,
                                        model=_port_model(arch))
            assert sum(got.values()) == want, (arch, name, got, want)
            cells += 1
    assert cells == 2 * 4 + 8 * 3


# -- roofline arithmetic ------------------------------------------------------

def _parts(pkg):
    ops = [pkg.CollectiveOp(kind, b, n, cross)
           for kind in ("all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute")
           for b, n, cross in ((4096, 16, False), (29360128, 16, True),
                               (224, 2, True), (1 << 20, 1, False))]
    return [{"flops": 1.657e14, "bytes": 8.75e12, "collectives": ops,
             "mult": 1},
            {"flops": 2.9e12, "bytes": 1.7e11, "collectives": ops[:7],
             "mult": 46},
            {"flops": 1.0e9, "mult": 3}]


def test_roofline_arithmetic_equals_the_reference():
    for r_op, t_op in zip(_parts(r_analyze)[0]["collectives"],
                          _parts(t_analyze)[0]["collectives"]):
        assert t_op.per_chip_link_bytes() == r_op.per_chip_link_bytes()
    want = r_analyze.terms_from_parts(_parts(r_analyze), 256)
    got = t_analyze.terms_from_parts(_parts(t_analyze), 256)
    for k in ("flops", "bytes_hbm", "coll_ici_bytes", "coll_dci_bytes",
              "chips"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.t_compute == got.flops / 989e12
    assert got.t_memory == got.bytes_hbm / 3.35e12
    assert got.t_collective == got.coll_ici_bytes / 450e9 \
        + got.coll_dci_bytes / 50e9
    d = got.as_dict()
    assert set(d) == set(want.as_dict())
    assert d["bottleneck"] == max(("compute", "memory", "collective"),
                                  key=lambda k: d[f"t_{k}"])


@pytest.mark.parametrize("dims", [(2,), (1,), (0,), (1, 2), (0, 1)])
def test_group_reach_equals_the_reference_parser(dims):
    """A group over mesh dims of (2, 16, 16), devices numbered row-major:
    its size and whether it spans nodes of 8, against the reference's
    parser reading XLA's iota replica groups."""
    sizes = (2, 16, 16)
    rest = [d for d in range(3) if d not in dims]
    perm = rest + list(dims)
    gsize = int(np.prod([sizes[d] for d in dims]))
    line = (f"all-reduce(x), replica_groups=[{512 // gsize},{gsize}]"
            f"<=[2,16,16]{{{','.join(map(str, perm))}}}")
    want = r_analyze._replica_group_info(line, 8)
    assert t_analyze.group_info(sizes, dims, 8) == want
    assert t_analyze.GPUS_PER_NODE == 8


# -- the counter --------------------------------------------------------------

def test_counter_bytes_and_peak():
    n = 1000

    def fn(a):
        b = a + 1                       # 4n made, 8n moved
        c = b * 2                       # 4n made (8n live), 8n moved
        del b                           # 4n live
        d = c.view(10, 100) + 1         # a view (nothing); 4n made, 8n live
        return d.sum()                  # 4n read + 4 written, 4 made
    spec = torch.empty(n, dtype=torch.float32, device="meta")
    c = counter.trace(fn, (spec,))
    assert c.bytes == 8 * n + 8 * n + 8 * n + 4 * n + 4
    assert c.peak == 8 * n + 4          # b's storage was freed first
    assert c.flops == 0
    mm = counter.trace(lambda x, w: x @ w, (
        torch.empty(3, 5, device="meta"), torch.empty(5, 7, device="meta")))
    assert mm.flops == 2 * 3 * 5 * 7


def _smoke(layers, remat):
    return dataclasses.replace(t_registry.get_smoke_config("qwen2-0.5b"),
                               num_layers=layers, remat=remat)


def _loss_grad_flops(cfg, b, s) -> int:
    lm = TLM(cfg)
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    return counter.trace(
        lambda p, t: t_ts.accumulated_grads(lm, p, {"tokens": t})[0],
        (lm.param_specs(), tokens)).flops


@pytest.mark.parametrize("low,high,remat", [(1, 4, "none"), (4, 8, "full")])
def test_fragment_identity(low, high, remat):
    """FLOPs(loss and grad at ``high`` layers) - FLOPs(at ``low``) =
    (high - low) x the grad-wrapped layer fragment's FLOPs, exactly. The
    fragment is the stacked group's body (remat as the config's); a group
    of fewer than 4 layers is not rematerialised, so the identity from 1
    layer holds without remat, and from 4 layers with it."""
    b, s = 2, 64
    cfg = _smoke(high, remat)
    frags = [f for f in TLM(cfg).fragments("train", b, s)
             if f.name == "layer_dense"]
    assert len(frags) == 1 and frags[0].extra_trips == high - 1
    one = counter.trace(dryrun._grad_wrap(frags[0].fn), frags[0].args,
                        grad=True).flops
    assert one > 0
    total = _loss_grad_flops(cfg, b, s)
    base = _loss_grad_flops(_smoke(low, remat), b, s)
    assert total - base == (high - low) * one


def test_fake_trace_flops_equal_a_real_step():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _smoke(4, "full")
    lm = TLM(cfg)
    ocfg = t_ts.opt_config_for(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    state = t_opt.init_opt_state(ocfg, params)
    tokens = torch.randint(0, cfg.vocab_size, (4, 96), dtype=torch.int32)
    step = t_ts.make_train_step(lm, ocfg, accum_steps=2)
    with FlopCounterMode(display=False) as real:
        step(params, state, {"tokens": tokens})
    fake = counter.trace(step, (lm.param_specs(),
                                t_opt.opt_state_specs(ocfg, params),
                                {"tokens": tokens.to("meta")}))
    assert fake.flops == real.get_total_flops() > 0


# -- the cell and the CLI -----------------------------------------------------

def test_dryrun_driver_small_cell():
    """The reference's ``test_system.py`` case on the port, in process."""
    rec = dryrun.run_cell("xlstm-125m", "decode_32k", multi_pod=False,
                          verbose=False)
    assert rec["status"] == "OK", rec.get("error")
    rl = dryrun.roofline_record(rec)
    assert rl and rl["t_memory"] > 0
    assert rec["memory"]["total_bytes_per_device"] < 16 * 2**30
    assert rec["trips_in_full"] and rec["full"]["partition"] == "traced"
    assert rec["chips"] == 256 and rl["chips"] == 256


DENSE_AND_MOE = ("granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-0.5b",
                 "internlm2-20b", "gemma3-27b", "gemma-2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_cells_are_the_dense_and_moe_families(arch):
    """A cell on a mesh wider than one device is traced on shards for
    every family: the dense and MoE ones (MLA included: deepseek's train,
    prefill and decode), the VLM, hybrid, SSM and encoder-decoder ones,
    each in train, prefill and decode, ``long_500k`` included for the SSM
    and hybrid families."""
    cfg = t_registry.get_config(arch)
    shapes = dict(t_registry.SHAPES)
    if cfg.family not in ("ssm", "hybrid"):
        assert arch in DENSE_AND_MOE + ("qwen2-vl-7b", "whisper-tiny")
        assert not t_registry.cell_supported(cfg, shapes.pop("long_500k"))[0]
    for name, shape in shapes.items():
        assert t_registry.cell_supported(cfg, shape)[0], (arch, name)
        assert dryrun.traced(cfg, shape), (arch, name)


def test_dryrun_cli_writes_records(tmp_path, capsys):
    """The CLI writes one record a cell (a skipped cell too), reads a
    record back instead of tracing again unless ``--force``, and exits 0
    when no cell failed."""
    argv = ["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads(
        (tmp_path / "xlstm-125m__decode_32k__single.json").read_text())
    assert rec["status"] == "OK"
    assert rec["roofline"] == dryrun.roofline_record(rec)
    for mesh in ("single", "multi"):
        skip = json.loads((tmp_path / f"qwen2-0.5b__long_500k__{mesh}.json"
                           ).read_text())
        assert skip["status"] == "SKIP" and skip["reason"]
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert "[cached] xlstm-125m__decode_32k__single.json: OK" in \
        capsys.readouterr().out


def test_collectives_from_the_layouts():
    """The layout-derived collectives (specs only, nothing traced):
    qwen2-0.5b's 14 heads keep attention replicated, so a train step on
    the single-pod mesh all-reduces the MLP's partial sums over the model
    axis three times a layer (forward, backward, remat's recompute) a
    microbatch, plus the vocab-sharded embedding's and head's; ZeRO
    reduce-scatters each split leaf a microbatch and all-gathers it once;
    deepseek's experts divide over (data, model), so its decode step
    all-to-alls twice a MoE layer; a one-device mesh has none."""
    single = dryrun.production_mesh(False)
    cfg = t_registry.get_config("qwen2-0.5b")
    model = _port_model("qwen2-0.5b")
    ops = dryrun.collectives(cfg, single, model, model.param_specs(),
                             "train", 2, 4, 4096)
    act = [o for o in ops if o["kind"] == "all-reduce"
           and o["result_bytes"] == 4 * 4096 * 896 * 2]
    assert len(act) == 1 and act[0]["count"] == 24 * 3 * 2 + 2 + 2
    assert all(o["group_size"] == 16 and o["crosses_pod"] for o in ops)
    rs = [o for o in ops if o["kind"] == "reduce-scatter"]
    ag = [o for o in ops if o["kind"] == "all-gather"]
    assert rs and all(o["count"] % 2 == 0 for o in rs)
    assert sum(o["result_bytes"] * 16 * o["count"] // 2 for o in rs) == \
        sum(o["result_bytes"] * o["count"] for o in ag)
    assert not [o for o in ops if o["kind"] == "all-to-all"]
    ds = t_registry.get_config("deepseek-v3-671b")
    dmodel = _port_model("deepseek-v3-671b")
    a2a = [o for o in dryrun.collectives(ds, single, dmodel,
                                         dmodel.param_specs(), "decode", 1,
                                         8, 1) if o["kind"] == "all-to-all"]
    n_moe = ds.num_layers - ds.moe.first_k_dense
    assert len(a2a) == 1 and a2a[0]["group_size"] == 256 \
        and a2a[0]["count"] == 2 * n_moe
    one = dryrun.StandInMesh(("data", "model"), (1, 1))
    assert dryrun.collectives(cfg, one, model, model.param_specs(), "train",
                              2, 4, 4096) == []
