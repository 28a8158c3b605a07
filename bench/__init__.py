"""The benchmark of the PyTorch port (``repro_torch``) on one H100:
open-loop serving through ``ServeEngine``. ``run.py`` runs a cell;
``sweep.py`` finds a cell's knee; ``control.py`` reads the correctness
check's two readings. It imports neither JAX nor the JAX package."""
