"""The artifact check of the port's benchmarks: every
``BENCH_torch_<x>.json`` at the repo root must exist, parse, carry the
required top-level keys of the reference's ``BENCH_<x>.json``
(``benchmarks.artifacts.SCHEMAS``) and hold only finite numbers.

    PYTHONPATH=src python -m benchmarks.torch_artifacts             # all
    PYTHONPATH=src python -m benchmarks.torch_artifacts BENCH_torch_zoo.json

The artifacts are written by ``benchmarks.torch_scheduler_bench``,
``benchmarks.torch_serve_bench``, ``benchmarks.torch_obs_bench`` and
``benchmarks.torch_placement_bench``, and all of them by
``benchmarks.torch_run``.
"""

from __future__ import annotations

import json
import pathlib
import sys

from benchmarks import artifacts


def port_name(name: str) -> str:
    """``BENCH_<x>.json`` -> ``BENCH_torch_<x>.json``."""
    assert name.startswith("BENCH_"), name
    return "BENCH_torch_" + name[len("BENCH_"):]


SCHEMAS = {port_name(n): keys for n, keys in artifacts.SCHEMAS.items()}

# the artifacts the port's benchmarks write: one for each of the
# reference's
EXPECTED = tuple(SCHEMAS)


def problems(name: str, data) -> list[str]:
    """What is wrong with one parsed artifact: required keys missing,
    non-finite numbers (``artifacts.check``'s rules and messages)."""
    required = SCHEMAS.get(name, ())
    if required and not isinstance(data, dict):
        return [f"{name}: expected a JSON object, got "
                f"{type(data).__name__}"]
    out = []
    absent = [k for k in required if k not in data]
    if absent:
        out.append(f"{name}: missing required keys {', '.join(absent)}")
    bad = artifacts._non_finite(data, name)
    if bad:
        out.append(f"{name}: non-finite numbers at {', '.join(bad[:5])}")
    return out


def check(names=EXPECTED, root: pathlib.Path = artifacts.ROOT) -> None:
    """Fail (SystemExit) unless every named port artifact exists under
    ``root``, parses, carries its reference schema's keys and holds only
    finite numbers. The messages are ``artifacts.check``'s: missing files
    first, all of them in one message, then each file's faults."""
    root = pathlib.Path(root)
    missing = [n for n in names if not (root / n).is_file()]
    if missing:
        raise SystemExit(
            f"missing benchmark artifacts at {root}: {', '.join(missing)}")
    errors: list[str] = []
    for n in names:
        try:
            data = json.loads((root / n).read_text())
        except ValueError as e:
            errors.append(f"{n}: unparseable ({e})")
            continue
        errors += problems(n, data)
    if errors:
        raise SystemExit("benchmark artifact check failed:\n  "
                         + "\n  ".join(errors))
    print(f"[port artifacts OK — {len(names)} checked at {root}]")

if __name__ == "__main__":
    check(tuple(sys.argv[1:]) or EXPECTED)
