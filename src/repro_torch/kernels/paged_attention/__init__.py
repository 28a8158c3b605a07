"""Paged attention: the CUDA kernel (``kernel``), its plain PyTorch
version (``ref``) and the dispatching ops (``ops``)."""
