"""The dry-run and roofline tables of the PyTorch port: the port of
``benchmarks/roofline_table.py`` over the port's records, written by
``python -m repro_torch.launch.dryrun`` into ``build/dryrun_torch/`` (one
JSON a cell). The tables and their columns are the reference's. The
"compile s" column is what the port's records hold under
``lower_compile_s``: the seconds the dry-run took to trace the cell on
fake tensors (PyTorch compiles nothing ahead of a step), not an XLA
lower-and-compile time.

    PYTHONPATH=src python -m benchmarks.torch_roofline_table
"""

from __future__ import annotations

import json

from repro_torch.launch.dryrun import RESULTS


def model_flops(arch: str, shape: str) -> float:
    """MODEL_FLOPS: 6*N*D train (N=active params, D=tokens); decode: 2*N*D
    per generated token batch; prefill: 2*N*D."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch)
    sh = registry.SHAPES[shape]
    n = cfg.param_counts()["active"]
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[sh.kind]
    return mult * n * tokens


def load_cells() -> list[dict]:
    cells = []
    for f in sorted(RESULTS.glob("*.json")):
        cells.append(json.loads(f.read_text()))
    return cells


def render(single_only_roofline: bool = True) -> str:
    cells = load_cells()
    if not cells:
        return ("(no dry-run results yet — run repro_torch.launch."
                "dryrun)\n")
    lines = []
    lines.append("### Dry-run status (lower+compile per cell)\n")
    lines.append("| arch | shape | mesh | status | compile s | "
                 "mem/dev GiB | accum |")
    lines.append("|---|---|---|---|---|---|---|")
    n_ok = n_skip = n_fail = 0
    for c in cells:
        st = c.get("status")
        n_ok += st == "OK"
        n_skip += st == "SKIP"
        n_fail += st == "FAIL"
        mem = c.get("memory", {}).get("total_bytes_per_device", 0) / 2 ** 30
        note = st if st != "SKIP" else f"SKIP ({c.get('reason', '')[:40]}…)"
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {note} | "
            f"{c.get('lower_compile_s', 0):.1f} | {mem:.2f} | "
            f"{c.get('accum_steps', 1)} |")
    lines.append(f"\nTotals: **{n_ok} OK, {n_skip} SKIP, {n_fail} FAIL** "
                 f"of {len(cells)} cells\n")

    lines.append("\n### Roofline terms (single-pod, per §Roofline)\n")
    lines.append("| arch | shape | t_comp s | t_mem s | t_coll s | "
                 "bottleneck | MODEL/HLO flops | roofline frac |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for c in cells:
        if c.get("status") != "OK" or "roofline" not in c:
            continue
        if single_only_roofline and c["mesh"] != "single":
            continue
        r = c["roofline"]
        try:
            mf = model_flops(c["arch"], c["shape"])
            useful = mf / max(r["flops"] * r["chips"], 1.0)
        except (KeyError, ValueError):
            useful = float("nan")
        dom = max(r["t_compute"], r["t_memory"], r["t_collective"])
        frac = r["t_compute"] / max(dom, 1e-12)
        lines.append(
            f"| {c['arch']} | {c['shape']} | {r['t_compute']:.3f} | "
            f"{r['t_memory']:.3f} | {r['t_collective']:.3f} | "
            f"{r['bottleneck']} | {useful:.2f} | {frac:.3f} |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(render())
