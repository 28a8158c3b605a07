"""Public flash-attention op with the reference's name and an ``impl``
argument (port of ``repro.kernels.flash_attention.ops``).

``impl=None`` picks by device: a CUDA tensor runs the hand-written CUDA
kernel, a CPU tensor runs the plain PyTorch version. ``impl="reference"``
runs the plain version on any device; it is taken only when a caller asks
for it (tests, ``chip_smoke.py``). ``impl="cuda"`` on a CPU tensor raises.
The reference's ``block_q``/``block_kv``/``interpret`` are TPU tiling
knobs and have no counterpart here.
"""

from __future__ import annotations

from repro_torch.kernels import use_kernel
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, window: int = 0, causal: bool = True,
                    impl: str | None = None):
    """q [B,S,nq,h], k/v [B,T,nkv,h] -> [B,S,nq,h]: full-sequence attention,
    causal or not, with an optional sliding window (``qpos - kpos <
    window``); KV head ``head // (nq // nkv)`` serves query head ``head``."""
    if use_kernel(impl, q):
        return kernel.flash_attention(q, k, v, window=window, causal=causal)
    return flash_attention_ref(q, k, v, window=window, causal=causal)
