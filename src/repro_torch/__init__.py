"""PyTorch port of the BWAP-paged serving stack (``repro``'s main path).

Module paths mirror the JAX package: ``repro_torch.placement.pool`` is the
counterpart of ``repro.placement.pool``. The numpy control plane (core/,
placement/ ledgers, scheduler/) is carried over unchanged, so placement
decisions and page ids match the reference bit for bit; the data plane
(pool tensors, model, paged attention) is torch, and the two paged
attention kernels are CUDA C++ for Hopper (``csrc/paged_attention.cu``).

The package never imports JAX or ``repro``. Entry points take a ``device``
(default ``"cuda"``) and raise when a card is asked for and none is
present.
"""
