"""The benchmark's files resolve by name, its traffic repeats under a seed,
its counts equal hand sums, and nothing of it imports JAX or the JAX
package (CPU)."""

from __future__ import annotations

import ast
import math
from pathlib import Path

import numpy as np
import pytest

from bench import cell, counts, traffic

BENCH = cell.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
HERE = Path(cell.__file__).resolve().parent


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = cell.workload(name)
    t = cell.traffic(w["traffic"])
    conf = cell.config(w["config"])
    assert t["config"] == w["config"] == conf["name"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (HERE.parent / entry["file"]).resolve() \
        == HERE / "configs" / f"{conf['name']}.json"
    assert entry["source"] == conf["source"]
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])
    parts = [("arrivals", t["arrivals"]["process"]),
             ("requests", t["requests"])]
    parts += [("lengths", v["dist"]) for v in t.values()
              if isinstance(v, dict) and "dist" in v]
    for kind, part in parts:
        assert (HERE / kind / f"{part}.py").is_file()
    for part in t.get("parts", {}):
        assert (HERE / "parts" / f"{part}.py").is_file()
    e2e = cell.metrics_of(name, "end_to_end")
    per = cell.metrics_of(name, "per_layer")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per
    for m in e2e + per:
        assert callable(cell.reader(m["name"]))
    for m in per:
        assert m["moves"] in names


def test_bounds_and_run_seconds():
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_traffic_repeats_under_a_seed(name):
    t = cell.traffic(name)
    a = traffic.generate(t, 2**31 + 5, 30.0, 1000)
    b = traffic.generate(t, 2**31 + 5, 30.0, 1000)
    c = traffic.generate(t, 2**31 + 6, 30.0, 1000)
    assert a == b and a != c
    # drawn, not shaped: another seed gives other sizes, not a reordering
    assert sorted(r.max_new for r in a) != sorted(r.max_new for r in c)
    assert all(x.due_s <= y.due_s for x, y in zip(a, a[1:]))
    assert 0 < a[0].due_s and a[-1].due_s < 30.0
    assert max(len(r.prompt) + r.max_new for r in a) \
        <= traffic.longest(t)
    if t["requests"] != "independent":
        return
    for spec, got in ((t["prompt"], [len(r.prompt) for r in a]),
                      (t["output"], [r.max_new for r in a])):
        assert spec["min"] <= min(got) and max(got) <= spec["max"]


def test_poisson_arrivals_are_poisson():
    """Exponential gaps of mean 1 / rate: the counts in unit intervals have
    the Poisson's mean and variance, and the gaps a coefficient of
    variation near 1 (a shaped, even schedule reads far below)."""
    rate, horizon = 8.0, 2000.0
    due = cell.plugin("arrivals", "poisson").due_times(
        {"rate_per_s": rate}, np.random.default_rng(11), horizon)
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.03)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)
    n = np.bincount(due.astype(int), minlength=int(horizon))
    assert n.var() / n.mean() == pytest.approx(1.0, abs=0.1)
    short = cell.plugin("arrivals", "poisson").due_times(
        {"rate_per_s": 1.0}, np.random.default_rng(0), 3.0)
    assert (short < 3.0).all()


@pytest.mark.parametrize("dist,spec", [
    ("lognormal", {"median": 100, "sigma": 0.5, "min": 1, "max": 10**6}),
    ("loguniform", {"min": 10, "max": 1000}),
    ("uniform", {"min": 3, "max": 9})])
def test_length_distributions(dist, spec):
    x = traffic.lengths(dict(spec, dist=dist), np.random.default_rng(1),
                        20000)
    assert x.min() >= spec["min"] and x.max() <= spec["max"]
    if dist == "lognormal":
        assert np.median(x) == pytest.approx(100, rel=0.03)
    elif dist == "loguniform":
        assert np.median(x) == pytest.approx(100, rel=0.05)
    else:
        assert set(np.unique(x)) == set(range(3, 10))


def test_parts_are_found_by_name():
    """What a traffic file names is a module of that name; a name with no
    module is refused, not read as a default."""
    assert callable(cell.plugin("requests", "independent").make)
    with pytest.raises(KeyError):
        cell.plugin("arrivals", "no_such_process")


def test_counts_equal_hand_sums():
    nq, nkv, hd = 4, 2, 16
    chunks = [(0, 5), (7, 3), (12, 1)]
    fl, nb = counts.paged_walk(chunks, nq, nkv, hd)
    pairs = sum(start + j + 1 for start, t in chunks for j in range(t))
    assert fl == 4 * nq * hd * pairs
    keys = sum(start + t for start, t in chunks)
    rows = sum(t for _, t in chunks)
    assert nb == 2 * (keys * 2 * nkv * hd + 2 * rows * nq * hd)
    assert counts.rowwise(3, 5, 7) == (2 * 3 * 5 * 7, 2 * (35 + 21 + 15))
    assert counts.least_s(989e12, 0) == 1.0
    assert counts.least_s(0, 3.35e12) == 1.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-7b"])
def test_model_counts_against_the_program(arch):
    """The frozen parameter count agrees with the program's own tree at
    the published widths (embedding and head aside)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    m = cell.config(arch)["model"]
    specs = LM(dataclasses.replace(registry.get_config(arch))).param_specs()

    def numel(t):
        if isinstance(t, dict):
            return sum(numel(v) for v in t.values())
        if isinstance(t, list):
            return sum(numel(v) for v in t)
        return t.numel()
    total = numel(specs)
    head = 0 if m["tie_word_embeddings"] else m["hidden_size"] \
        * m["vocab_size"]
    assert counts.non_embedding_params(m) + head \
        + m["hidden_size"] * m["vocab_size"] == total
    fl = counts.model_flops(m, tokens=3, keys=10, logit_rows=1)
    d, nq = m["hidden_size"], m["num_attention_heads"]
    want = (6 * counts.non_embedding_params(m) + 4 * d
            * m["num_hidden_layers"] * 10 + 2 * d * m["vocab_size"])
    assert fl == pytest.approx(want, rel=1e-12)
    assert d // nq * nq == d


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "torch"}


def test_weights_in_the_programs_tree():
    """The harness's seeded tree has the program's leaves and shapes."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from bench import weights
    from bench.tests import smoke_cell
    for arch in ("qwen2-0.5b", "qwen2-vl-7b"):
        m = smoke_cell.MODELS[arch]
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  param_dtype="bfloat16")
        want = LM(cfg).param_specs()
        got = weights.make(m, 3, torch.device("cpu"))
        flat = lambda t, p="": ({p: tuple(t.shape)} if torch.is_tensor(t)
                                else {k: v for i, x in (t.items() if isinstance(t, dict) else enumerate(t))
                                      for k, v in flat(x, f"{p}/{i}").items()})
        assert flat(got) == flat(want)
        again = weights.make(m, 3, torch.device("cpu"))
        assert torch.equal(got["embed"], again["embed"])
        assert np.isclose(float(got["embed"].float().std()),
                          1 / math.sqrt(m["hidden_size"]), rtol=0.1)
