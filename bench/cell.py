"""What ``BENCHMARK.json`` and the traffic files name, resolved to the
benchmark's files by name: ``configs/<config>.json``, ``traffic/<cell>.json``,
and the modules ``<kind>/<name>.py`` beside this file: ``metrics/`` (a
reader a metric), ``arrivals/`` (an arrival process), ``lengths/`` (a length
distribution), ``requests/`` (how a request's prompt and output length are
made) and ``parts/`` (an engine option that needs an object built). Adding a
configuration, a cell, a metric or one of those adds files and entries;
nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def workload(name: str, bench: dict | None = None) -> dict:
    bench = bench if bench is not None else benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(cell: str) -> dict:
    return load_json(HERE / "traffic" / f"{cell}.json")


def metrics_of(cell: str, kind: str, bench: dict | None = None) -> list[dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics the cell
    reports: those that list it, and those that list no cells."""
    bench = bench if bench is not None else benchmark()
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` beside this file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(record) -> float | None`` of ``metrics/<metric>.py``."""
    return plugin("metrics", metric).read
