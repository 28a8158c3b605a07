"""Device resolution for the port's entry points.

Every entry point takes a ``device`` (default ``"cuda"``). Asking for CUDA
on a machine without a card raises: the port never carries on silently on
the CPU. The tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for a config dtype name (``"bfloat16"``, ``"float32"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
