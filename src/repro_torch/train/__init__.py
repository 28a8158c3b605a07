"""Training-side entry points (port of ``repro.train``; only the eval step
so far)."""
