"""Quickstart: the BWAP core library in 60 seconds, on the PyTorch port's
core (``repro_torch.core``, pure numpy). The port of
``examples/quickstart.py``: it prints the same lines.

    PYTHONPATH=src python examples/torch_quickstart.py
"""

import numpy as np

from repro_torch.core import interleave, topology
from repro_torch.core.canonical import CanonicalTuner
from repro_torch.core.dwp import DWPConfig, DWPTuner
from repro_torch.core.simulator import PAPER_WORKLOADS, NumaSimulator

# 1. A NUMA machine (the paper's 8-node Opteron, reconstructed) ------------
mach = topology.machine_a()
print(f"{mach.name}: {mach.num_nodes} nodes, "
      f"local bw {mach.local_bw(0):.0f} GB/s, "
      f"amplitude {mach.bw.max() / mach.bw[mach.bw > 0].min():.1f}x")

# 2. Canonical weights for a 2-node worker set (Eq. 5) ---------------------
tuner = CanonicalTuner(mach)
entry = tuner.weights_for([0, 1])
print("\ncanonical weights (w_i ∝ minbw_i):")
for i, w in enumerate(entry.weights):
    tag = "worker" if i in (0, 1) else "      "
    print(f"  node {i} {tag}  w={w:.3f}  minbw={entry.minbw[i]:.2f} GB/s")

# 3. Weighted page interleaving (Alg. 1) -----------------------------------
pages = interleave.weighted_interleave(4096, entry.weights)
frac = interleave.page_fractions(pages, mach.num_nodes)
print(f"\nAlg.1 page fractions match weights: "
      f"max err {np.abs(frac - entry.weights).max():.4f}")

# 4. Online DWP tuning against the simulator -------------------------------
sim = NumaSimulator(mach)
app = PAPER_WORKLOADS["SC"]
dwp_tuner = DWPTuner(entry.weights, workers=[0, 1], num_pages=4096,
                     config=DWPConfig(n=8, c=2))
while not dwp_tuner.done:
    w = interleave.dwp_weights(entry.weights, [0, 1], dwp_tuner.dwp)
    stall = sim.run(app, [0, 1], "weighted", w, noise=0.01).stall_rate
    dwp_tuner.record(stall)
print(f"\nDWP tuner converged at DWP={dwp_tuner.dwp:.1f} "
      f"after {len(dwp_tuner.history)} periods")

# 5. The punchline: BWAP vs the usual suspects ------------------------------
w_final = interleave.dwp_weights(entry.weights, [0, 1], dwp_tuner.dwp)
t_bwap = sim.run(app, [0, 1], "weighted", w_final).time
for pol in ("first_touch", "uniform_workers", "uniform_all"):
    t = sim.run(app, [0, 1], pol).time
    print(f"  {pol:16s} {t / t_bwap:5.2f}x slower than BWAP")
