"""Row-invariant weight product: the CUDA kernel (``kernel``), its plain
PyTorch version (``ref``) and the dispatching op (``ops``)."""
